"""The port's search workflow: `search` and `easy_search` on a torch device.

`SearchParams`, the m8 formatting and the per-stage timers are host code with
`foldseek_tpu`'s flags, defaults and output bytes.
"""
from ..utils.log import (reset_stage_times, snapshot_stage_counts,
                         snapshot_stage_times)
from .convertalis import format_results
from .params import SearchParams
from .pipeline import easy_search, search

__all__ = ["SearchParams", "easy_search", "format_results",
           "reset_stage_times", "search", "snapshot_stage_counts",
           "snapshot_stage_times"]
