"""Driver of the program's structure search: the generated DB as the port's
in-memory `StructDB`, the configuration's search settings as its
`SearchParams`, and one call = `search` of a batch of queries followed by
`format_results` of their m8 lines, as `easy-search` does without files.

This is the only file of the benchmark that imports the program, and it
imports nothing but the entry points a user's script would.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

QUERY_KEY_BASE = 1_000_000_000      # query keys never collide with the DB's


def struct_db(res, names: List[str], keys: np.ndarray):
    from foldseek_tpu_torch.db.storage import StructDB
    return StructDB(
        path="", aa=res.aa, ss=res.ss,
        mask=np.zeros(len(res.aa), dtype=np.uint8), ca=res.ca,
        offsets=res.offsets, keys=np.asarray(keys, dtype=np.uint32),
        names=names, headers=names,
        fileids=np.zeros(res.size, dtype=np.uint32))


class SearchDriver:
    def __init__(self, cfg: Dict, db, device, rank: int = 0, size: int = 1):
        """The program's DB and settings on this rank's `device`. Every rank
        of a world gets the whole generated DB; `rank` and `size` let a
        driver keep only its share."""
        from foldseek_tpu_torch.search.params import SearchParams
        names = [f"T{i}" for i in range(db.size)]
        self.tdb = struct_db(db, names, np.arange(db.size))
        self.params = SearchParams(**cfg["search"])
        self.device = device
        self.rank, self.size = rank, size

    @staticmethod
    def join_world(init_method: str, rank: int, size: int, device: str,
                   timeout_seconds: float) -> None:
        """Form the program's world of `size` ranks, this process as `rank`
        on `device`, as a user's script does before any other work."""
        from foldseek_tpu_torch.parallel.distributed import init_distributed
        init_distributed(init_method=init_method, world_size=size, rank=rank,
                         device=device, timeout_seconds=timeout_seconds)

    def batch(self, queries, idx: np.ndarray):
        """Query DB of pool entries `idx` (made before the window)."""
        from benchmark.gen.families import take
        names = [f"Q{i}" for i in idx]
        return struct_db(take(queries, idx), names,
                         QUERY_KEY_BASE + np.asarray(idx, dtype=np.int64))

    def call_search(self, qdb):
        from foldseek_tpu_torch.search.pipeline import search
        return search(qdb, self.tdb, self.params, self.device, same_db=False)

    def call_format(self, qdb, res) -> List[str]:
        from foldseek_tpu_torch.search.convertalis import format_results
        p = self.params
        return format_results(qdb, self.tdb, res, p.format_output,
                              with_backtrace=p.add_backtrace)

    def call(self, qdb):
        """One user call: the search and its m8 lines."""
        res = self.call_search(qdb)
        return res, self.call_format(qdb, res)

    @staticmethod
    def reset_counters() -> None:
        from foldseek_tpu_torch.utils.log import reset_stage_times
        reset_stage_times()

    @staticmethod
    def counters():
        """(stage seconds, stage counts) the program recorded since the
        last reset (utils/log.py)."""
        from foldseek_tpu_torch.utils.log import (snapshot_stage_counts,
                                                  snapshot_stage_times)
        return snapshot_stage_times(), snapshot_stage_counts()

    @staticmethod
    def query_key(i: int) -> int:
        return QUERY_KEY_BASE + int(i)

    @staticmethod
    def records(res, qkey: int) -> List[dict]:
        """The program's records of one query as plain dicts."""
        return [dict(key=int(r.db_key), score=int(r.score),
                     q_start=int(r.q_start), q_end=int(r.q_end),
                     t_start=int(r.t_start), t_end=int(r.t_end),
                     evalue=float(r.evalue), backtrace=r.backtrace)
                for r in res.get(qkey, [])]
