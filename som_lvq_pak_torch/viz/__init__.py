"""Host text writers of the visualisation tools (sammon, planes, umat): the
port's copies of som_lvq_pak_tpu/viz/."""

from .eps import sammon_eps, ps_string_filter

__all__ = ["sammon_eps", "ps_string_filter"]
