"""Substitution matrices (3Di + amino acid) with reference-exact integer scaling.

The reference parses half-bit score files (data/mat3di.out, blosum62.out),
reconstructs the joint probability model with the precomputed lambda and
background frequencies from the file header, and regenerates integer scores at
an arbitrary bit scale (reference: lib/mmseqs/src/commons/SubstitutionMatrix.cpp:326-420,
BaseMatrix.cpp:97-159). We replicate that float64 math exactly so integer
scores match bit-for-bit:

  prob[i][j]  = exp(lambda * S_file[i][j]) * p[i] * p[j]
  pBack'[i]   = sum_j prob[i][j]        (X row forced to ANY_BACK = 1e-5)
  S[i][j]     = round_half_away(bitFactor * log2(prob[i][j] / (pBack'[i] pBack'[j])) + bias)

Default factors (reference: src/strucclustutils/structurealign.cpp:252-265):
3Di at bitFactor 2.1, AA (blosum62) at 1.4 in 3Di+AA mode.
"""
from __future__ import annotations

import functools
import os
import re

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

ANY_BACK = 1e-5  # reference: lib/mmseqs/src/commons/BaseMatrix.h (ANY_BACK)

# Alphabet order is the row/column order of the matrix files; X is last.
ALPHABET = "ACDEFGHIKLMNPQRSTVWYX"
ALPHA_SIZE = len(ALPHABET)  # 21

# 3Di bit scale 2.1 / AA 1.4 in combined mode (structurealign.cpp:252,264)
BIT_FACTOR_3DI = 2.1
BIT_FACTOR_AA = 1.4
GAP_OPEN = 10  # LocalParameters.cpp:346
GAP_EXTEND = 1  # LocalParameters.cpp:347


def aa_to_num_table() -> np.ndarray:
    """256-entry char->index table. Unknowns and lowercase map like the
    reference (SubstitutionMatrix::setAaMappingDetectAlphSize + Sequence):
    unknown residues map to X; lowercase letters map to their uppercase code."""
    table = np.full(256, ALPHABET.index("X"), dtype=np.int8)
    for i, ch in enumerate(ALPHABET):
        table[ord(ch)] = i
        table[ord(ch.lower())] = i
    return table


AA2NUM = aa_to_num_table()


def encode_seq(seq: str) -> np.ndarray:
    return AA2NUM[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def decode_seq(nums) -> str:
    return "".join(ALPHABET[i] for i in np.asarray(nums))


class SubstitutionMatrix:
    """Parsed + rescaled substitution matrix.

    Attributes:
      scores:  int16 [21, 21] integer substitution scores at `bit_factor` scale
      prob:    float64 [21, 21] joint probabilities
      back:    float64 [21] background frequencies (post-renormalization)
      sub_f32: float32 [21, 21] of `scores` (for device use)
      lam:     ungapped lambda of the half-bit file scores
    """

    def __init__(self, path: str, bit_factor: float, score_bias: float = 0.0):
        self.bit_factor = float(bit_factor)
        self.score_bias = float(score_bias)
        file_scores, lam, p_file = _parse_matrix_file(path)
        self.lam = lam
        self.file_scores = file_scores

        # X column check: reference renormalizes non-X background when X has no
        # positive score (SubstitutionMatrix.cpp:370-409)
        x = ALPHA_SIZE - 1
        x_is_positive = bool((file_scores[x, :] > 0).any() or (file_scores[:, x] > 0).any())
        p = p_file.copy()
        if not x_is_positive:
            p[:x] = p[:x] * (1.0 - p[x])

        prob = np.exp(lam * file_scores) * p[:, None] * p[None, :]
        self.prob = prob

        # the renormalized file-header background — this is what m->pBack holds
        # and what calcLocalAaBiasCorrection reads (SubstitutionMatrix.cpp:404-409)
        self.p_back = p
        # BaseMatrix::computeBackground: row sums, X row forced to ANY_BACK —
        # used only to regenerate the integer scores
        back = prob.sum(axis=1)
        back[x] = ANY_BACK
        self.back = back

        sub = np.log2(prob / (back[:, None] * back[None, :]))
        self.sub_float = sub
        scaled = self.bit_factor * sub + self.score_bias
        # round half away from zero, like the reference's +-0.5 cast
        self.scores = np.where(scaled < 0.0, scaled - 0.5, scaled + 0.5).astype(np.int16)
        self.sub_f32 = self.scores.astype(np.float32)
        # pseudo-count matrix P(a|b) used for profiles (BaseMatrix.cpp:118-122)
        self.pseudo_counts = (prob / back[None, :]).astype(np.float32)

    def score(self, a: str, b: str) -> int:
        return int(self.scores[ALPHABET.index(a), ALPHABET.index(b)])


def _parse_matrix_file(path):
    lam = None
    back = None
    rows = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                if "Background" in line:
                    nums = re.findall(r"[0-9.eE+-]+", line.split(":", 1)[1])
                    back = np.array([float(v) for v in nums], dtype=np.float64)
                elif "Lambda" in line:
                    lam = float(line.split(":", 1)[1].strip())
                continue
            parts = line.split()
            if not parts:
                continue
            if parts[0] == ALPHABET[0] and len(parts) == ALPHA_SIZE and not _is_number(parts[1]):
                continue  # header row of letters
            if len(parts) == ALPHA_SIZE + 1 and parts[0] in ALPHABET:
                rows[parts[0]] = [float(v) for v in parts[1:]]
    if lam is None or back is None:
        raise ValueError(f"{path}: missing precomputed lambda/background header")
    mat = np.zeros((ALPHA_SIZE, ALPHA_SIZE), dtype=np.float64)
    for ch, vals in rows.items():
        mat[ALPHABET.index(ch)] = vals
    return mat, lam, back[:ALPHA_SIZE]


def _is_number(tok):
    try:
        float(tok)
        return True
    except ValueError:
        return False


@functools.lru_cache(maxsize=None)
def mat3di(bit_factor: float = BIT_FACTOR_3DI, score_bias: float = 0.0) -> SubstitutionMatrix:
    return SubstitutionMatrix(os.path.join(DATA_DIR, "mat3di.out"), bit_factor, score_bias)


@functools.lru_cache(maxsize=None)
def blosum62(bit_factor: float = BIT_FACTOR_AA, score_bias: float = 0.0) -> SubstitutionMatrix:
    return SubstitutionMatrix(os.path.join(DATA_DIR, "blosum62.out"), bit_factor, score_bias)
