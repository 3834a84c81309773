"""The port's counterparts of examples/large_som.py (BASELINE config 4) and
examples/streaming_som.py (config 5), run as
`python -m som_lvq_pak_torch.examples.large_som` and
`python -m som_lvq_pak_torch.examples.streaming_som`."""
