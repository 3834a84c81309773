"""Measurement tools run on the card, counterparts of the JAX package's
tools/int8_probe.py and tools/int8_step_ab.py:

    python -m som_lvq_pak_torch.tools.int8_probe
    python -m som_lvq_pak_torch.tools.int8_step_ab

Their functions take `device=` ("cuda" unless the caller asks for "cpu",
which runs the plain versions at a small size, timed by the host clock)."""
