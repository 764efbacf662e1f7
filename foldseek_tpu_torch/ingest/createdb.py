"""createdb: structure files -> array-native StructDB.

Mirrors the reference ingest program (reference: src/strucclustutils/structcreatedb.cpp):
walk files/dirs, parse PDB/mmCIF(+gz), per chain apply the <=3-residue and
all-X filters (:486-501), detect C-alpha-only chains (:504-518), encode 3Di,
apply b-factor masking to lowercase (:524-531), then sort all entries by
entry name and assign sequential keys (:1353-1382).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..db.storage import StructDB, StructDBWriter
from ..ops.matrices import encode_seq
from ..utils.log import logger
from . import pdb as pdb_parser
from .encoder3di import encode_chain

STRUCTURE_EXTS = (".pdb", ".cif", ".mmcif", ".ent", ".pdb.gz", ".cif.gz",
                  ".mmcif.gz", ".ent.gz")


def coordinate16_roundtrip(ca) -> np.ndarray:
    """Store C-alpha exactly as the reference's readers will SEE them:
    createdb compresses _ca with Coordinate16 (int32 start + int16 diffs of
    trunc(x*1000), structcreatedb.cpp:636-638) and every consumer decodes
    (start + cumdiff) / 1000.0f (Coordinate16.h:15-56) — i.e. the effective
    coordinate is float32(int32(trunc(x_double * 1000)) / 1000.0f), per
    axis, UNLESS any consecutive diff overflows int16 (a >32.7 A jump), in
    which case the whole chain stays raw float32. Reproducing this
    quantization at ingest makes every CA-derived number (TM, LDDT, rmsd,
    u/t, structure bits) byte-comparable with the reference binary."""
    ca = np.asarray(ca, dtype=np.float64)
    if ca.size == 0:
        return ca.astype(np.float32)
    q = np.trunc(ca * 1000.0)
    # int16 diff overflow check per axis (convertToDiff16 returns true)
    if len(ca) > 1:
        d = np.diff(q, axis=0)
        if (np.abs(d) > 32767).any():
            return ca.astype(np.float32)
    if (np.abs(q) > 2**31 - 1).any():  # int32 start overflow safety
        return ca.astype(np.float32)
    # C semantics: int32 value converted to float, then float division
    return q.astype(np.int32).astype(np.float32) / np.float32(1000.0)


_TAR_CACHE: dict = {}


def _tar_handle(archive: str):
    """Open tar + name->TarInfo map, cached per (path, mtime, size).

    tarfile's getmember()/extractfile(name) rescan the member list (and,
    before _load, the archive itself) on EVERY call — per-member access
    through them is O(archive) and made tar ingest O(N^2): 2k members
    cost ~140 s, 100k would be hours. One full scan here, then every
    member read seeks straight to its stored offset."""
    import tarfile
    st = os.stat(archive)
    key = (os.path.abspath(archive), st.st_mtime_ns, st.st_size)
    hit = _TAR_CACHE.get(key)
    if hit is None:
        while len(_TAR_CACHE) >= 8:  # bound open fds
            old = next(iter(_TAR_CACHE))
            try:
                _TAR_CACHE.pop(old)[0].close()
            except Exception:
                pass
        tf = tarfile.open(archive)
        hit = (tf, {m.name: m for m in tf.getmembers()})
        _TAR_CACHE[key] = hit
    return hit


def collect_input_files(inputs: List[str],
                        file_include: str = ".*",
                        file_exclude: str = "^$",
                        tar_include: str = ".*",
                        tar_exclude: str = "^$") -> List[str]:
    """Files, directories (recursive) and tar archives (.tar/.tar.gz; members
    are referenced as 'archive.tar::member' — structcreatedb.cpp's tar
    loop equivalent). Directory entries are filtered by the
    --file-include/--file-exclude regexes on the basename, tar members by
    --tar-include/--tar-exclude on the member name
    (LocalParameters.cpp:29-30, structcreatedb.cpp tar loop). Explicitly
    listed files are never filtered."""
    import re
    finc, fexc = re.compile(file_include), re.compile(file_exclude)
    tinc, texc = re.compile(tar_include), re.compile(tar_exclude)
    files = []
    for inp in inputs:
        if inp.startswith(("gs://", "gcs://")):
            # GCS bucket walking (structcreatedb.cpp:1058-1288)
            import tempfile

            from .gcs import fetch_gcs_inputs
            cache = os.environ.get(
                "FOLDSEEK_TPU_GCS_CACHE",
                os.path.join(tempfile.gettempdir(), "foldseek_tpu_gcs"))
            files.extend(fetch_gcs_inputs(inp, cache,
                                          file_include, file_exclude))
        elif os.path.isdir(inp):
            for root, _, fnames in os.walk(inp):
                for fn in sorted(fnames):
                    if finc.search(fn) and not fexc.search(fn):
                        files.append(os.path.join(root, fn))
        elif inp.endswith((".tar", ".tar.gz", ".tgz")) and os.path.isfile(inp):
            _, members = _tar_handle(inp)
            for m in sorted(members):
                if members[m].isfile() and tinc.search(m) \
                        and not texc.search(m):
                    files.append(f"{inp}::{m}")
        elif os.path.isfile(inp):
            files.append(inp)
        else:
            raise FileNotFoundError(inp)
    return files


def _parse_any(path: str, input_format: int = 0):
    """parse_structure with tar-member and foldcomp (.fcz) support."""
    from . import foldcomp as fc
    if "::" in path and not os.path.exists(path):
        import gzip as gz
        archive, member = path.split("::", 1)
        tf, members = _tar_handle(archive)
        data = tf.extractfile(members[member]).read()
        if member.endswith(".gz"):
            data = gz.decompress(data)
            member = member[:-3]
        elif member.endswith((".zst", ".zstd")):
            from ..utils import zstd
            data = zstd.decompress(data)
            member = member.rsplit(".", 1)[0]
        base = os.path.basename(member)
        if fc.is_fcz(data):
            return fc.to_structure(fc.decode_fcz(data),
                                   remove_two_extensions(base))
        text = data.decode("utf-8", errors="replace")
        return pdb_parser.parse_structure_text(text, base,
                                               input_format=input_format)
    with open(path, "rb") as f:
        head = f.read(4)
    if head == fc.MAGIC:
        return fc.to_structure(fc.read_fcz(path),
                               remove_two_extensions(os.path.basename(path)))
    if input_format == 5:  # forced Foldcomp, but no FCMP magic
        raise ValueError(f"{path}: --input-format 5 but not a foldcomp file")
    return pdb_parser.parse_structure(path, input_format=input_format)


def _parse_structures(path: str, input_format: int = 0):
    """All structures from one input path: a foldcomp DB (data file with an
    .index sidecar whose entries start with FCMP) yields one per entry;
    everything else yields one."""
    from . import foldcomp as fc
    if (os.path.isfile(path) and os.path.exists(path + ".index")
            and not path.endswith((".index", ".lookup", ".dbtype"))):
        with open(path, "rb") as f:
            if f.read(4) == fc.MAGIC:
                return [fc.to_structure(st, name)
                        for name, st in fc.iter_foldcomp_db(path)]
    return [_parse_any(path, input_format)]


def is_ca_only(ch) -> bool:
    """C-alpha-only chain detection: first 4 N and C rows all-NaN
    (structcreatedb.cpp:504-518); such chains get a PULCHRA-style
    backbone rebuild before 3Di encoding."""
    import numpy as _np
    return (len(ch.aa) >= 4 and _np.isnan(ch.n[:4, 0]).all()
            and _np.isnan(ch.c[:4, 0]).all())


def remove_two_extensions(name: str) -> str:
    """reference: structcreatedb.cpp:1366-1371 (sort key for entry ordering)."""
    if name.endswith((".gz", ".zstd", ".zst")):
        name = os.path.splitext(name)[0]
        name = os.path.splitext(name)[0]
        return os.path.splitext(name)[0]
    name = os.path.splitext(name)[0]
    return os.path.splitext(name)[0]


def parse_fasta(path: str) -> List[tuple]:
    """[(header, sequence)] from a FASTA file (optionally gzipped)."""
    import gzip
    opener = gzip.open if path.endswith(".gz") else open
    entries = []
    name, seq = None, []
    with opener(path, "rt") as f:
        for line in f:
            line = line.rstrip()
            if line.startswith(">"):
                if name is not None:
                    entries.append((name, "".join(seq)))
                name = line[1:]
                seq = []
            elif line:
                seq.append(line)
    if name is not None:
        entries.append((name, "".join(seq)))
    return entries


def _looks_like_fasta(path: str) -> bool:
    import gzip
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt") as f:
            for line in f:
                if line.strip():
                    return line.startswith(">")
    except (OSError, UnicodeDecodeError):
        return False
    return False


def create_db_prostt5(inputs: List[str], out_path: str,
                      model_file: str, device="cuda") -> StructDB:
    """FASTA -> AA + ProstT5-predicted 3Di DB (no coordinates)
    (reference: structcreatedb.cpp:697-872 ProstT5 path); the encoder runs
    on `device`."""
    from ..device import get_device
    from ..nn.prostt5 import ProstT5
    from ..utils.log import span
    with span("prostt5_load"):
        model = ProstT5(model_file=model_file,
                        device=get_device(str(device)))
    entries = []
    for file_id, path in enumerate(collect_input_files(inputs)):
        for header, seq in parse_fasta(path):
            name = header.split()[0] if header.split() else header
            entries.append((name, header, seq, file_id))
    seqs = [e[2] for e in entries]
    logger.info("ProstT5: predicting 3Di for %d sequences", len(seqs))
    ss_strings = model.predict(seqs)
    order = sorted(range(len(entries)),
                   key=lambda i: (remove_two_extensions(entries[i][0]), i))
    writer = StructDBWriter(out_path)
    for new_key, idx in enumerate(order):
        name, header, seq, file_id = entries[idx]
        writer.add_entry(new_key, name, header,
                         encode_seq(seq.upper()), encode_seq(ss_strings[idx]),
                         ca=None, file_id=file_id)
    db = writer.finish()
    logger.info("createdb(ProstT5): %d entries", db.size)
    return db


def create_db(inputs: List[str], out_path: str,
              chain_name_mode: str = "auto",
              mask_bfactor_threshold: float = 0.0,
              prostt5_model: str = "",
              file_include: str = ".*", file_exclude: str = "^$",
              tar_include: str = ".*", tar_exclude: str = "^$",
              input_format: int = 0, device="cuda") -> StructDB:
    """`device` is where ProstT5 runs when `prostt5_model` is given; the
    structure path is host work."""
    if prostt5_model:
        return create_db_prostt5(inputs, out_path, prostt5_model, device)
    files = collect_input_files(inputs, file_include, file_exclude,
                                tar_include, tar_exclude)
    entries = []  # (entry_name, header, aa_num, ss_num, ca, mask, file_id)
    too_short = 0
    not_protein = 0
    failed = 0
    for file_id, path in enumerate(files):
        try:
            sts = _parse_structures(path, input_format)
        except Exception as e:  # noqa: BLE001 - ingest must survive bad files
            logger.warning("failed to parse %s: %s", path, e)
            failed += 1
            continue

        for st in sts:
            multi_chain = len(st.chains) > 1
            for ch in st.chains:
                L = len(ch.aa)
                if L <= 3:
                    too_short += 1
                    continue
                if all(c in "Xx" for c in ch.aa):
                    not_protein += 1
                    continue
                ca_only = is_ca_only(ch)
                n_arr, c_arr = ch.n, ch.c
                if ca_only:
                    # backbone rebuild for C-alpha-only traces (PULCHRA
                    # equivalent; structcreatedb.cpp:504-518)
                    from .backbone import rebuild_backbone
                    n_arr, c_arr = rebuild_backbone(ch.ca, ch.aa)
                    logger.info("%s chain %s is C-alpha only; backbone rebuilt",
                                st.name, ch.name)
                states = encode_chain(ch.ca, n_arr, c_arr, ch.cb)
                name = st.name
                if st.model_count > 1:
                    name = f"{name}_MODEL_{ch.model}"
                if chain_name_mode == "add" or (chain_name_mode == "auto" and multi_chain):
                    name = f"{name}_{ch.name}"
                header = name
                if st.title:
                    header = f"{name} {st.title}"
                mask = (ch.bfactor < mask_bfactor_threshold).astype(np.uint8)
                ca = coordinate16_roundtrip(np.nan_to_num(ch.ca, nan=0.0))
                entries.append((name, header, encode_seq(ch.aa), states, ca, mask,
                                file_id))

    # sort by name (two extra extensions removed) with stable tie order,
    # assign sequential keys (structcreatedb.cpp:1356-1382); source-file
    # (set) ids are renumbered to first appearance in the SORTED entry
    # order like the reference's lookup rewrite (qset/qsetid columns and
    # the .lookup third column follow the sorted enumeration)
    order = sorted(range(len(entries)),
                   key=lambda i: (remove_two_extensions(entries[i][0]), i))
    src_names = [remove_two_extensions(os.path.basename(p)) for p in files]
    fid_map = {}
    for idx in order:
        fid = entries[idx][6]
        if fid not in fid_map:
            fid_map[fid] = len(fid_map)
    writer = StructDBWriter(out_path)
    writer.sources = [None] * len(fid_map)
    for old, new in fid_map.items():
        writer.sources[new] = (src_names[old] if old < len(src_names)
                               else str(old))
    for new_key, idx in enumerate(order):
        name, header, aa_num, ss_num, ca, mask, file_id = entries[idx]
        writer.add_entry(new_key, name, header, aa_num, ss_num, ca, mask,
                         file_id=fid_map.get(file_id, 0))
    db = writer.finish()
    logger.info("createdb: %d entries (%d too short, %d not protein, %d failed files)",
                db.size, too_short, not_protein, failed)
    return db
