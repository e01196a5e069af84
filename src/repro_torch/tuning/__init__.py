"""Kernel blocking (port of ``repro.tuning``): the analytic tier only.

The reference resolves every tile through a registry (persistent cache,
then autotune, then the analytic solve).  The port has the analytic page
size of the paged decode cache so far; the cache and autotune tiers wait
for the registry (ROADMAP queue 1, item 4).
"""

from repro_torch.tuning.attention import resolve_page_size

__all__ = ["resolve_page_size"]
