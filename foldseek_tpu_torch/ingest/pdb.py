"""PDB / mmCIF structure parsing to flat per-chain backbone arrays.

Clean-room parser of the public PDB and mmCIF formats producing the same
per-chain arrays the reference extracts with gemmi
(reference: src/strucclustutils/GemmiWrapper.cpp:786-905):
CA/CB/N/C coordinates (NaN when absent), one-letter amino acids via the
modified-residue table (GemmiWrapper.cpp:188-338), CA b-factors, chain names,
model indices. Residues without a CA atom are dropped; waters and unknown
het groups without backbone are excluded.
"""
from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass, field
from typing import List

import numpy as np

# Three-letter -> one-letter mapping, including modified residues, identical to
# the reference's table (GemmiWrapper.cpp:188-338). Unknown -> 'X'.
THREE_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ABA": "A", "ASP": "D", "ASX": "B",
    "CYS": "C", "CSH": "S", "GLN": "Q", "GLU": "E", "GLX": "Z", "GLY": "G",
    "HIS": "H", "ILE": "I", "LEU": "L", "LYS": "K", "MET": "M", "MSE": "M",
    "ORN": "A", "PHE": "F", "PRO": "P", "SER": "S", "THR": "T", "TRY": "W",
    "TRP": "W", "TYR": "Y", "UNK": "X", "VAL": "V", "SEC": "C", "PYL": "O",
    "SEP": "S", "TPO": "T", "PCA": "E", "CSO": "C", "PTR": "Y", "KCX": "K",
    "CSD": "C", "LLP": "K", "CME": "C", "MLY": "K", "DAL": "A", "TYS": "Y",
    "OCS": "C", "M3L": "K", "FME": "M", "ALY": "K", "HYP": "P", "CAS": "C",
    "CRO": "T", "CSX": "C", "DPR": "P", "DGL": "E", "DVA": "V", "CSS": "C",
    "DPN": "F", "DSN": "S", "DLE": "L", "HIC": "H", "NLE": "L", "MVA": "V",
    "MLZ": "K", "CR2": "G", "SAR": "G", "DAR": "R", "DLY": "K", "YCM": "C",
    "NRQ": "M", "CGU": "E", "0TD": "D", "MLE": "L", "DAS": "D", "DTR": "W",
    "CXM": "M", "TPQ": "Y", "DCY": "C", "DSG": "N", "DTY": "Y", "DHI": "H",
    "MEN": "N", "DTH": "T", "SAC": "S", "DGN": "Q", "AIB": "A", "SMC": "C",
    "IAS": "D", "CIR": "R", "BMT": "T", "DIL": "I", "FGA": "E", "PHI": "F",
    "CRQ": "Q", "SME": "M", "GHP": "G", "MHO": "M", "NEP": "H", "TRQ": "W",
    "TOX": "W", "ALC": "A", "SCH": "C", "MDO": "A", "MAA": "A", "GYS": "S",
    "MK8": "L", "CR8": "H", "KPI": "K", "SCY": "C", "DHA": "S", "OMY": "Y",
    "CAF": "C", "0AF": "W", "SNN": "N", "MHS": "H", "SNC": "C", "PHD": "D",
    "B3E": "E", "MEA": "F", "MED": "M", "OAS": "S", "GL3": "G", "FVA": "V",
    "PHL": "F", "CRF": "T", "BFD": "D", "MEQ": "Q", "DAB": "A", "AGM": "R",
    "4BF": "Y", "B3A": "A", "B3D": "D", "B3K": "K", "B3Y": "Y", "BAL": "A",
    "DBZ": "A", "GPL": "K", "HSK": "H", "HY3": "P", "HZP": "P", "KYN": "W",
    "MGN": "Q",
}

WATER_NAMES = {"HOH", "WAT", "DOD", "H2O"}


@dataclass
class Chain:
    name: str
    model: int
    aa: str = ""
    ca: np.ndarray = None
    cb: np.ndarray = None
    n: np.ndarray = None
    c: np.ndarray = None
    bfactor: np.ndarray = None


@dataclass
class Structure:
    name: str  # file basename, extensions stripped
    title: str = ""
    model_count: int = 1
    chains: List[Chain] = field(default_factory=list)


def three_to_one(resname: str) -> str:
    if len(resname) != 3:
        return "X"
    return THREE_TO_ONE.get(resname, "X")


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8", errors="replace")
    if path.endswith((".zst", ".zstd")):
        from ..utils import zstd
        data = zstd.decompress(open(path, "rb").read())
        return io.StringIO(data.decode("utf-8", errors="replace"))
    return open(path, encoding="utf-8", errors="replace")


def strip_structure_ext(filename: str) -> str:
    """basename with one extension removed; two if compressed
    (structcreatedb.cpp:533-537)."""
    base = os.path.basename(filename)
    if base.endswith((".gz", ".zstd", ".zst")):
        base = os.path.splitext(base)[0]
    return os.path.splitext(base)[0]


def parse_structure(path: str, input_format: int = 0) -> Structure:
    with _open_maybe_gz(path) as f:
        text = f.read()
    return parse_structure_text(text, strip_structure_ext(path), _strip=False,
                                input_format=input_format)


def parse_structure_text(text: str, filename: str, _strip: bool = True,
                         input_format: int = 0) -> Structure:
    """input_format forces a parser (LocalParameters.cpp:36 --input-format:
    0 auto, 1 PDB, 2 mmCIF, 3 mmJSON); auto-detection sniffs content, which
    also covers extension-less files (stricter than the reference's
    extension dispatch)."""
    name = strip_structure_ext(filename) if _strip else filename
    if input_format == 1:
        return parse_pdb_text(text, name)
    if input_format == 2:
        return parse_mmcif_text(text, name)
    if input_format == 3:
        return parse_mmjson_text(text, name)
    if _looks_like_mmjson(text):
        return parse_mmjson_text(text, name)
    if _looks_like_cif(text):
        return parse_mmcif_text(text, name)
    return parse_pdb_text(text, name)


def _looks_like_mmjson(text: str) -> bool:
    head = text[:4096].lstrip()
    return head.startswith("{") and '"atom_site"' in text[:65536]


def _looks_like_cif(text: str) -> bool:
    head = text[:4096]
    return head.lstrip().startswith("data_") or "_atom_site." in head or "loop_" in head[:256]


class _ResidueAccum:
    """Accumulates one residue's atoms; first altloc conformer wins per atom,
    later same-name atoms in the same conformer overwrite (the reference's
    last-wins atom loop operates on gemmi's first_conformer view)."""

    __slots__ = ("resname", "atoms", "first_alt", "bfactor")

    def __init__(self, resname):
        self.resname = resname
        self.atoms = {}
        self.first_alt = None
        self.bfactor = 0.0

    def add(self, atom_name, altloc, x, y, z, bfactor):
        if altloc not in ("", " "):
            if self.first_alt is None:
                self.first_alt = altloc
            elif altloc != self.first_alt:
                return
        if atom_name == "CA":
            self.bfactor = bfactor
        self.atoms[atom_name] = (x, y, z)


def _finish_chain(chain_name, model_idx, residues):
    if not residues:
        return None
    L = len(residues)
    ca = np.full((L, 3), np.nan)
    cb = np.full((L, 3), np.nan)
    n = np.full((L, 3), np.nan)
    c = np.full((L, 3), np.nan)
    bf = np.zeros(L, dtype=np.float32)
    aa = []
    kept = 0
    for r in residues:
        if "CA" not in r.atoms:
            continue
        ca[kept] = r.atoms["CA"]
        if "CB" in r.atoms:
            cb[kept] = r.atoms["CB"]
        if "N" in r.atoms:
            n[kept] = r.atoms["N"]
        if "C" in r.atoms:
            c[kept] = r.atoms["C"]
        bf[kept] = r.bfactor
        aa.append(three_to_one(r.resname))
        kept += 1
    if kept == 0:
        return None
    return Chain(
        name=chain_name, model=model_idx, aa="".join(aa),
        ca=ca[:kept], cb=cb[:kept], n=n[:kept], c=c[:kept], bfactor=bf[:kept],
    )


def parse_pdb_text(text: str, name: str) -> Structure:
    st = Structure(name=name)
    title_parts = []
    model_idx = 1
    model_count = 0
    seen_model_record = False
    # per (model) ordered chains; each chain: ordered residue list
    chains: List[Chain] = []
    cur_chain_id = None
    cur_residues = []
    cur_res = None
    cur_res_key = None

    def flush_res():
        nonlocal cur_res, cur_res_key
        if cur_res is not None:
            cur_residues.append(cur_res)
        cur_res = None
        cur_res_key = None

    def flush_chain():
        nonlocal cur_residues, cur_chain_id
        flush_res()
        if cur_chain_id is not None and cur_residues:
            ch = _finish_chain(cur_chain_id, model_idx, cur_residues)
            if ch is not None:
                chains.append(ch)
        cur_residues = []
        cur_chain_id = None

    for line in text.splitlines():
        rec = line[:6]
        if rec == "TITLE ":
            title_parts.append(line[10:80].rstrip())
        elif rec == "MODEL ":
            flush_chain()
            seen_model_record = True
            model_count += 1
            try:
                model_idx = int(line[6:].strip() or model_count)
            except ValueError:
                model_idx = model_count
        elif rec in ("ATOM  ", "HETATM"):
            resname = line[17:20].strip()
            if resname in WATER_NAMES:
                continue
            chain_id = line[21]
            if chain_id != cur_chain_id:
                flush_chain()
                cur_chain_id = chain_id
            res_key = (line[22:27], resname)  # seqid+icode; alt residue names at
            if cur_res_key is not None and res_key[0] == cur_res_key[0] and res_key[1] != cur_res_key[1]:
                continue  # microheterogeneity: first residue name wins
            if res_key != cur_res_key:
                flush_res()
                cur_res = _ResidueAccum(resname)
                cur_res_key = res_key
            try:
                x = float(line[30:38])
                y = float(line[38:46])
                z = float(line[46:54])
            except ValueError:
                continue
            try:
                bf = float(line[60:66])
            except (ValueError, IndexError):
                bf = 0.0
            cur_res.add(line[12:16].strip(), line[16].strip(), x, y, z, bf)
        elif rec == "ENDMDL":
            flush_chain()
        elif rec in ("TER   ", "TER"):
            flush_chain()
        elif rec == "END   ":
            flush_chain()
    flush_chain()

    st.title = " ".join(p for p in title_parts if p).strip()
    st.model_count = max(model_count, 1) if seen_model_record else 1
    st.chains = chains
    return st


def parse_mmjson_text(text: str, name: str) -> Structure:
    """mmJSON (PDBj's JSON rendering of mmCIF: {"data_XXXX": {category:
    {tag: [column...]}}}) — same source format gemmi::cif::read_mmjson
    handles (reference: src/strucclustutils/GemmiWrapper.cpp:504-517)."""
    import json
    doc = json.loads(text)
    st = Structure(name=name)
    block = None
    for k, v in doc.items():
        if isinstance(v, dict) and "atom_site" in v:
            block = v
            break
    if block is None:
        return st
    struct = block.get("struct") or {}
    titles = struct.get("title") or []
    if titles and titles[0]:
        st.title = str(titles[0])
    site = block["atom_site"]

    def column(*keys):
        for k in keys:
            if k in site and site[k] is not None:
                return site[k]
        return None

    xs, ys, zs = site.get("Cartn_x"), site.get("Cartn_y"), site.get("Cartn_z")
    if not xs:
        return st
    n_rows = len(xs)

    def cell(colv, i, default=""):
        if colv is None or i >= len(colv):
            return default
        v = colv[i]
        return default if v is None else str(v)

    atom_id = column("label_atom_id", "auth_atom_id")
    alt_id = column("label_alt_id")
    comp_id = column("label_comp_id", "auth_comp_id")
    asym_id = column("auth_asym_id", "label_asym_id")
    seq_id = column("auth_seq_id", "label_seq_id")
    icode = column("pdbx_PDB_ins_code")
    model_no = column("pdbx_PDB_model_num")
    group = column("group_PDB")
    biso = column("B_iso_or_equiv")

    chains = []
    cur_chain_key = None
    cur_residues = []
    cur_res = None
    cur_res_key = None
    model_ids = set()

    def flush_res():
        nonlocal cur_res, cur_res_key
        if cur_res is not None:
            cur_residues.append(cur_res)
        cur_res = None
        cur_res_key = None

    def flush_chain():
        nonlocal cur_residues, cur_chain_key
        flush_res()
        if cur_chain_key is not None and cur_residues:
            ch = _finish_chain(cur_chain_key[0], cur_chain_key[1], cur_residues)
            if ch is not None:
                chains.append(ch)
        cur_residues = []
        cur_chain_key = None

    for i in range(n_rows):
        resname = cell(comp_id, i)
        if resname in WATER_NAMES:
            continue
        if cell(group, i, "ATOM") not in ("ATOM", "HETATM"):
            continue
        model = int(cell(model_no, i, "1") or 1)
        model_ids.add(model)
        key = (cell(asym_id, i), model)
        if key != cur_chain_key:
            flush_chain()
            cur_chain_key = key
        res_key = (cell(seq_id, i) + cell(icode, i), resname)
        if (cur_res_key is not None and res_key[0] == cur_res_key[0]
                and res_key[1] != cur_res_key[1]):
            continue
        if res_key != cur_res_key:
            flush_res()
            cur_res = _ResidueAccum(resname)
            cur_res_key = res_key
        try:
            x, y, z = float(xs[i]), float(ys[i]), float(zs[i])
        except (TypeError, ValueError):
            continue
        try:
            bf = float(cell(biso, i, "0") or 0.0)
        except ValueError:
            bf = 0.0
        cur_res.add(cell(atom_id, i), cell(alt_id, i), x, y, z, bf)
    flush_chain()

    st.model_count = max(len(model_ids), 1)
    st.chains = chains
    return st


def _parse_chemcomp(lines, st: Structure) -> Structure:
    """Single-residue structure from a _chem_comp_atom loop (ChemComp
    input format; gemmi chemcomp_xyz.hpp). Coordinate tag preference
    follows gemmi's model order: x / model_Cartn_x /
    pdbx_model_Cartn_x_ideal — foldseek reads the first model."""
    i = 0
    tags = []
    rows = []
    comp_id = ""
    while i < len(lines):
        if lines[i].strip() == "loop_":
            cand = []
            j = i + 1
            while j < len(lines) and lines[j].startswith("_"):
                cand.append(lines[j].split()[0])
                j += 1
            if cand and cand[0].startswith("_chem_comp_atom."):
                tags = [t.split(".", 1)[1] for t in cand]
                while j < len(lines):
                    row = lines[j]
                    if not row or row.startswith(("#", "loop_", "_", "data_")):
                        break
                    rows.append(row.split())
                    j += 1
                break
            i = j
            continue
        i += 1
    if not tags:
        return st
    cols = {t: k for k, t in enumerate(tags)}
    for trip in (("x", "y", "z"),
                 ("model_Cartn_x", "model_Cartn_y", "model_Cartn_z"),
                 ("pdbx_model_Cartn_x_ideal", "pdbx_model_Cartn_y_ideal",
                  "pdbx_model_Cartn_z_ideal")):
        if all(t in cols for t in trip):
            xyz = trip
            break
    else:
        return st
    if "comp_id" in cols and rows:
        comp_id = rows[0][cols["comp_id"]]
    acc = _ResidueAccum(comp_id or st.name)
    for row in rows:
        try:
            x = float(row[cols[xyz[0]]])
            y = float(row[cols[xyz[1]]])
            z = float(row[cols[xyz[2]]])
        except (ValueError, IndexError):
            continue
        atom_id = row[cols["atom_id"]] if "atom_id" in cols else ""
        acc.add(atom_id, "", x, y, z, 0.0)
    ch = _finish_chain("", 1, [acc])
    if ch is not None:
        st.chains = [ch]
    return st


def parse_mmcif_text(text: str, name: str) -> Structure:
    """Minimal mmCIF parser: _atom_site loop + title."""
    st = Structure(name=name)
    lines = text.splitlines()
    i = 0
    title = ""
    atom_rows = []
    columns = None
    while i < len(lines):
        line = lines[i]
        if line.startswith("_struct.title"):
            rest = line[len("_struct.title"):].strip()
            if rest:
                title = rest.strip("'\"")
            elif i + 1 < len(lines):
                title = lines[i + 1].strip().strip("'\";")
        if line.strip() == "loop_":
            # gather tags
            tags = []
            j = i + 1
            while j < len(lines) and lines[j].startswith("_"):
                tags.append(lines[j].split()[0])
                j += 1
            if tags and tags[0].startswith("_atom_site."):
                columns = {t.split(".", 1)[1]: k for k, t in enumerate(tags)}
                while j < len(lines):
                    row = lines[j]
                    if not row or row.startswith(("#", "loop_", "_", "data_")):
                        break
                    atom_rows.append(row.split())
                    j += 1
            i = j
            continue
        i += 1

    st.title = title
    if not columns:
        # chemical-component CIF (CCD entry / Refmac monomer library): no
        # _atom_site loop, coordinates in _chem_comp_atom
        # (GemmiWrapper.h:20 Format::ChemComp,
        # lib/gemmi/chemcomp_xyz.hpp make_structure_from_chemcomp_doc) —
        # a single-residue model; the normal min-length filter then drops
        # it downstream exactly like the reference
        return _parse_chemcomp(lines, st)

    def col(row, key, default=""):
        idx = columns.get(key)
        if idx is None or idx >= len(row):
            return default
        v = row[idx]
        return "" if v in (".", "?") else v

    chains = []
    cur_chain_key = None
    cur_residues = []
    cur_res = None
    cur_res_key = None
    model_ids = set()

    def flush_res():
        nonlocal cur_res, cur_res_key
        if cur_res is not None:
            cur_residues.append(cur_res)
        cur_res = None
        cur_res_key = None

    def flush_chain():
        nonlocal cur_residues, cur_chain_key
        flush_res()
        if cur_chain_key is not None and cur_residues:
            ch = _finish_chain(cur_chain_key[0], cur_chain_key[1], cur_residues)
            if ch is not None:
                chains.append(ch)
        cur_residues = []
        cur_chain_key = None

    for row in atom_rows:
        resname = col(row, "label_comp_id") or col(row, "auth_comp_id")
        if resname in WATER_NAMES:
            continue
        group = col(row, "group_PDB", "ATOM")
        if group not in ("ATOM", "HETATM"):
            continue
        model = int(col(row, "pdbx_PDB_model_num", "1") or 1)
        model_ids.add(model)
        chain_id = col(row, "auth_asym_id") or col(row, "label_asym_id")
        key = (chain_id, model)
        if key != cur_chain_key:
            flush_chain()
            cur_chain_key = key
        seq_id = col(row, "auth_seq_id") or col(row, "label_seq_id")
        icode = col(row, "pdbx_PDB_ins_code")
        res_key = (seq_id + icode, resname)
        if cur_res_key is not None and res_key[0] == cur_res_key[0] and res_key[1] != cur_res_key[1]:
            continue
        if res_key != cur_res_key:
            flush_res()
            cur_res = _ResidueAccum(resname)
            cur_res_key = res_key
        try:
            x = float(col(row, "Cartn_x"))
            y = float(col(row, "Cartn_y"))
            z = float(col(row, "Cartn_z"))
        except ValueError:
            continue
        try:
            bf = float(col(row, "B_iso_or_equiv") or 0.0)
        except ValueError:
            bf = 0.0
        cur_res.add(col(row, "label_atom_id") or col(row, "auth_atom_id"),
                    col(row, "label_alt_id"), x, y, z, bf)
    flush_chain()

    st.model_count = max(len(model_ids), 1)
    st.chains = chains
    return st
