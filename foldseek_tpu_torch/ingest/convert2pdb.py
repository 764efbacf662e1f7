"""convert2pdb: structure DB -> C-alpha-only PDB file(s)
(reference: src/strucclustutils/convert2pdb.cpp).

Output modes (LocalParameters.h:103-105): 0 = one multi-model PDB file,
1 = one PDB per complex (chains grouped by source file), 2 = one PDB per
chain. ATOM lines match the reference's "%8.3f" CA-only format.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..db.storage import StructDB
from ..ops.matrices import ALPHABET
from ..utils.log import logger

PDB_OUTPUT_MODE_MULTIMODEL = 0
PDB_OUTPUT_MODE_COMPLEX = 1
PDB_OUTPUT_MODE_SINGLECHAIN = 2

# standard residue three-letter codes indexed like our numeric alphabet
THREE = {
    "A": "ALA", "C": "CYS", "D": "ASP", "E": "GLU", "F": "PHE", "G": "GLY",
    "H": "HIS", "I": "ILE", "K": "LYS", "L": "LEU", "M": "MET", "N": "ASN",
    "P": "PRO", "Q": "GLN", "R": "ARG", "S": "SER", "T": "THR", "V": "VAL",
    "W": "TRP", "Y": "TYR", "X": "UNK",
}


def _title_lines(header: str) -> List[str]:
    out = [f"TITLE     {header[:70]}"]
    rest = header[70:]
    cont = 2
    while rest:
        out.append(f"TITLE  {cont:>3d}{rest[:70]}")
        rest = rest[70:]
        cont += 1
    return out


def _atom_lines(db: StructDB, i: int, chain: str) -> List[str]:
    ca = np.asarray(db.get_ca(i))
    aa = db.get_aa_str(i).upper()
    out = []
    for j in range(len(ca)):
        aa3 = THREE.get(aa[j], "UNK")
        out.append(
            f"ATOM  {j + 1:5d}  CA  {aa3} {chain[0]}{j + 1:4d}    "
            f"{ca[j][0]:8.3f}{ca[j][1]:8.3f}{ca[j][2]:8.3f}")
    return out


def _chain_letter(db: StructDB, i: int) -> str:
    name = db.names[i]
    pos = name.rfind("_")
    return name[pos + 1:] if 0 <= pos < len(name) - 1 else "A"


def convert2pdb(db: StructDB, out_path: str,
                mode: int = PDB_OUTPUT_MODE_MULTIMODEL):
    if mode == PDB_OUTPUT_MODE_MULTIMODEL:
        with open(out_path, "w") as f:
            for i in range(db.size):
                f.write(f"MODEL {int(db.keys[i]):8d}\n")
                for line in _title_lines(db.headers[i]):
                    f.write(line + "\n")
                for line in _atom_lines(db, i, _chain_letter(db, i)):
                    f.write(line + "\n")
                f.write("ENDMDL\n")
            # no trailing END record: the reference's multimodel writer
            # ends at the last ENDMDL (convert2pdb.cpp) and parity wins
        logger.info("convert2pdb: %d models -> %s", db.size, out_path)
        return

    os.makedirs(out_path, exist_ok=True)
    if mode == PDB_OUTPUT_MODE_COMPLEX:
        groups: Dict[int, List[int]] = {}
        for i in range(db.size):
            cid = int(db.fileids[i]) if db.fileids is not None else i
            groups.setdefault(cid, []).append(i)
        for cid, members in groups.items():
            name = db.names[members[0]]
            pos = name.rfind("_")
            base = name[:pos] if pos > 0 else name
            with open(os.path.join(out_path, base + ".pdb"), "w") as f:
                for i in members:
                    for line in _title_lines(db.headers[i]):
                        f.write(line + "\n")
                    for line in _atom_lines(db, i, _chain_letter(db, i)):
                        f.write(line + "\n")
                f.write("END\n")
        logger.info("convert2pdb: %d complexes -> %s/", len(groups), out_path)
    else:
        for i in range(db.size):
            with open(os.path.join(out_path, db.names[i] + ".pdb"), "w") as f:
                for line in _title_lines(db.headers[i]):
                    f.write(line + "\n")
                for line in _atom_lines(db, i, _chain_letter(db, i)):
                    f.write(line + "\n")
                f.write("END\n")
        logger.info("convert2pdb: %d chains -> %s/", db.size, out_path)
