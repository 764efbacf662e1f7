"""The DBs' key maps (db/storage.py `StructDB.key_to_index`): built once per
`keys` array, read-only, rebuilt where `keys` is replaced, the same mapping
as a loop over the keys, and searches against one target DB that reuse its
map write the m8 lines of searches against a freshly loaded one."""
import dataclasses

import numpy as np
import pytest
import torch

from foldseek_tpu_torch.cluster.workflow import _subdb_view
from foldseek_tpu_torch.db.storage import StructDB, load_db
from foldseek_tpu_torch.db.synth import synth_db
from foldseek_tpu_torch.ingest.createdb import create_db
from foldseek_tpu_torch.search import SearchParams, format_results
from foldseek_tpu_torch.search import pipeline as tpipe
from foldseek_tpu_torch.utils import log

from _torch_adapters import few_torch_threads

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from few_torch_threads()


@pytest.fixture(scope="module")
def paths(golden_dir, tmp_path_factory):
    """Paths of the 17-entry fixture DB expanded to 120 targets and 4
    queries."""
    d = tmp_path_factory.mktemp("torch_key_maps")
    inputs = ([str(p) for p in sorted((golden_dir / "msa" / "sup")
                                      .glob("*.pdb"))]
              + [str(golden_dir / "d1asha.fcz")])
    base = create_db(inputs, str(d / "base"))
    synth_db(base, 120, str(d / "t120"), seed=1)
    synth_db(base, 4, str(d / "q4"), seed=4)
    return str(d / "t120"), str(d / "q4")


def _loop_map(keys):
    """The map as a loop over the keys builds it: the last row of a
    repeated key wins."""
    return {int(k): i for i, k in enumerate(keys)}


def _db(keys) -> StructDB:
    n = len(keys)
    return StructDB(path="", aa=np.zeros(n, np.int8), ss=np.zeros(n, np.int8),
                    mask=np.zeros(n, np.uint8), ca=None,
                    offsets=np.arange(n + 1, dtype=np.int64),
                    keys=np.asarray(keys, dtype=np.uint32),
                    names=[str(k) for k in keys],
                    headers=[str(k) for k in keys])


def test_two_calls_return_one_map(paths):
    db = load_db(paths[0])
    log.reset_stage_times()
    first = db.key_to_index()
    assert db.key_to_index() is first
    assert dict(first) == _loop_map(db.keys)
    assert log.snapshot_stage_counts() == {"key_maps.built": [db.size],
                                           "key_maps.reused": [1]}


def test_map_is_read_only():
    m = _db([3, 1, 2]).key_to_index()
    with pytest.raises(TypeError):
        m[9] = 0
    with pytest.raises(TypeError):
        del m[3]
    assert not hasattr(m, "pop") and not hasattr(m, "update")
    assert dict(m) == {3: 0, 1: 1, 2: 2}


@pytest.mark.parametrize("new_keys", [[7, 8, 9], [5, 6], [4, 3, 2, 1]],
                         ids=["same_length", "shorter", "longer"])
def test_replaced_keys_get_a_fresh_map(new_keys):
    db = _db([1, 2, 3])
    old = db.key_to_index()
    db.keys = np.asarray(new_keys, dtype=np.uint32)
    log.reset_stage_times()
    fresh = db.key_to_index()
    assert fresh is not old and dict(old) == {1: 0, 2: 1, 3: 2}
    assert dict(fresh) == _loop_map(new_keys)
    assert log.snapshot_stage_counts()["key_maps.built"] == [len(new_keys)]


def test_copies_and_views_get_their_own_map(paths):
    db = load_db(paths[0])
    held = db.key_to_index()
    copy = dataclasses.replace(db)
    assert copy.keys is db.keys
    log.reset_stage_times()
    assert copy.key_to_index() is not held
    assert dict(copy.key_to_index()) == dict(held)
    assert log.snapshot_stage_counts()["key_maps.built"] == [db.size]
    sub_keys = [int(k) for k in db.keys[10:20]]
    view = _subdb_view(db, sub_keys)
    assert dict(view.key_to_index()) == {k: i for i, k in
                                         enumerate(sorted(sub_keys))}
    assert db.key_to_index() is held


def test_repeated_keys_last_row_wins():
    keys = [4, 9, 4, 1, 9, 9]
    m = _db(keys).key_to_index()
    assert dict(m) == _loop_map(keys) == {4: 2, 9: 5, 1: 3}


@pytest.mark.parametrize("mode", [1, 3])
def test_searches_reusing_the_target_map_match_fresh_dbs(paths, mode,
                                                         monkeypatch):
    """Two calls of search + m8 lines against one target DB object, each
    with a query DB of its own (as a server's calls come): the lines equal,
    byte for byte, those of the same calls on freshly loaded DBs, and the
    target DB's map is built once across both calls."""
    monkeypatch.delenv("FOLDSEEK_TPU_DEVICE_GATES", raising=False)
    params = SearchParams(prefilter_mode=mode, add_backtrace=True)

    def call(qdb, tdb):
        res = tpipe.search(qdb, tdb, params, CPU, same_db=False)
        return format_results(qdb, tdb, res, params.format_output,
                              with_backtrace=True)

    tdb = load_db(paths[0])
    log.reset_stage_times()
    held = [call(load_db(paths[1]), tdb) for _ in range(2)]
    built = log.snapshot_stage_counts()["key_maps.built"]
    qsize = load_db(paths[1]).size
    assert built.count(tdb.size) == 1 and set(built) == {tdb.size, qsize}
    assert log.stage_count("key_maps.reused") > 0
    fresh = [call(load_db(paths[1]), load_db(paths[0])) for _ in range(2)]
    assert held[0]
    assert ["\n".join(lines).encode() for lines in held] == \
        ["\n".join(lines).encode() for lines in fresh]
