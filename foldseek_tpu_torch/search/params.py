"""Search parameters — the foldseek-visible knobs with reference defaults
(reference: src/commons/LocalParameters.cpp:320-365,
lib/mmseqs/src/commons/Parameters.cpp:2440-2520)."""
from __future__ import annotations

from dataclasses import dataclass, field

INT_MAX = 2**31 - 1

ALIGNMENT_TYPE_TMALIGN = 1
ALIGNMENT_TYPE_3DI_AA = 2
ALIGNMENT_TYPE_LOLALIGN = 3

PREF_MODE_KMER = 0
PREF_MODE_UNGAPPED = 1
PREF_MODE_EXHAUSTIVE = 2
PREF_MODE_UNGAPPED_AND_GAPPED = 3


@dataclass
class SearchParams:
    # alignment
    alignment_type: int = ALIGNMENT_TYPE_3DI_AA
    gap_open: int = 10
    gap_extend: int = 1
    evalue_thr: float = 10.0
    seq_id_thr: float = 0.0
    aln_len_thr: int = 0
    cov_thr: float = 0.0
    cov_mode: int = 0   # bidirectional
    max_accept: int = INT_MAX
    max_rejected: int = INT_MAX
    comp_bias_correction: bool = True
    comp_bias_correction_scale: float = 0.5  # structurealign default (:33)
    add_backtrace: bool = False
    alt_alignment: int = 0
    include_identity: bool = False
    seq_id_mode: int = 0  # SEQ_ID_ALN_LEN

    # structure gates / scoring
    sort_by_structure_bits: bool = True
    tmscore_threshold: float = 0.0
    tmscore_threshold_mode: int = 0  # alignment-length normalization
    lddt_threshold: float = 0.0
    exact_tmscore: bool = False
    # tmalign module (LocalParameters.cpp:13,22): hit order
    # 0 (qTM+tTM)/2, 1 qTM, 2 tTM, 3 min, 4 max; --tmalign-fast default 1
    tmalign_hit_order: int = 0
    tmalign_fast: bool = True

    # iterative profile search (--num-iterations); --e-profile caps the
    # non-final iterations' e-value gate (unset -> 0.001,
    # StructureSearch.cpp:163-170)
    num_iterations: int = 1
    e_profile: float = -1.0  # < 0 = unset
    # search cluster representatives then expand hits through members
    # (--cluster-search, StructureSearch.cpp:193-247)
    cluster_search: int = 0

    # prefilter
    prefilter_mode: int = PREF_MODE_KMER
    exhaustive_search: bool = False
    sensitivity: float = 9.5
    kmer_size: int = 0  # 0 = auto
    max_seqs: int = 1000

    # output
    format_output: str = ("query,target,fident,alnlen,mismatch,gapopen,"
                          "qstart,qend,tstart,tend,evalue,bits")
    format_mode: int = 0

    threads: int = 1
    # unix socket of a running index server (gpuserver analogue); when set,
    # the prefilter stage queries the resident device panels there
    index_server: str = ""

    def validate(self) -> "SearchParams":
        """Range checks mirroring the reference's per-flag regexes
        (Parameters.cpp PARAM_* regex column, e.g. `^0(\\.[0-9]+)?|^1(\\.0+)?$`
        for -c). Raises ValueError with the offending flag's name."""
        checks = [
            ("-c/--cov-thr", 0.0 <= self.cov_thr <= 1.0),
            ("--cov-mode", 0 <= self.cov_mode <= 5),
            ("--min-seq-id", 0.0 <= self.seq_id_thr <= 1.0),
            ("-e/--evalue", self.evalue_thr >= 0.0),
            ("--gap-open", self.gap_open >= 0),
            ("--gap-extend", self.gap_extend >= 0),
            ("--alignment-type", 0 <= self.alignment_type <= 3),
            ("--prefilter-mode", 0 <= self.prefilter_mode <= 3),
            ("--tmscore-threshold", 0.0 <= self.tmscore_threshold <= 1.0),
            ("--lddt-threshold", 0.0 <= self.lddt_threshold <= 1.0),
            ("--tmscore-threshold-mode",
             0 <= self.tmscore_threshold_mode <= 2),
            ("--tmalign-hit-order", 0 <= self.tmalign_hit_order <= 4),
            ("-s/--sensitivity", 1.0 <= self.sensitivity <= 20.0),
            ("-k/--kmer-size", self.kmer_size == 0
             or 5 <= self.kmer_size <= 7),
            ("--max-seqs", self.max_seqs >= 1),
            ("--num-iterations", self.num_iterations >= 1),
            ("--alt-ali", self.alt_alignment >= 0),
            ("--format-mode", 0 <= self.format_mode <= 5),
            ("--threads", self.threads >= 0),
        ]
        for flag, ok in checks:
            if not ok:
                raise ValueError(f"invalid value for {flag}")
        return self



def can_be_covered_mask(cov_thr: float, cov_mode: int, q_len: int, t_lens):
    """Vectorized Util::canBeCovered over an array of target lengths."""
    import numpy as np
    t = np.asarray(t_lens, dtype=np.float64)
    if cov_thr <= 0.0:
        return np.ones(len(t), dtype=bool)
    q = float(q_len)
    if cov_mode == 0:
        return (q / t >= cov_thr) & (t / q >= cov_thr)
    if cov_mode == 1:
        return q / t >= cov_thr
    if cov_mode == 2:
        return t / q >= cov_thr
    if cov_mode == 3:
        return (t / q >= cov_thr) & (t / q <= 1.0)
    if cov_mode == 4:
        return (q / t >= cov_thr) & (q / t <= 1.0)
    if cov_mode == 5:
        r = np.minimum(t, q) / np.maximum(t, q)
        return r >= cov_thr
    return np.ones(len(t), dtype=bool)

def has_coverage(cov_thr: float, cov_mode: int, q_cov: float, t_cov: float) -> bool:
    """reference: Util.h hasCoverage (modes 0-5)."""
    if cov_thr <= 0.0:
        return True
    if cov_mode == 0:    # bidirectional
        return q_cov >= cov_thr and t_cov >= cov_thr
    if cov_mode == 1:    # target
        return t_cov >= cov_thr
    if cov_mode == 2:    # query
        return q_cov >= cov_thr
    if cov_mode == 3:    # target-in-query length ratio handled in canBeCovered
        return True
    return True


def can_be_covered(cov_thr: float, cov_mode: int, q_len: int, t_len: int) -> bool:
    """reference: Util::canBeCovered (Util.cpp) — length-ratio pre-gate
    applied by the prefilters, rescorediagonal and the alignment module.
    Deliberately conservative: with target coverage (mode 1) a shorter
    query can never reach the threshold by this gate even though query
    gaps can stretch the aligned target span past it — the reference
    drops such pairs at the prefilter and so do we."""
    if cov_thr <= 0.0:
        return True
    q, t = float(q_len), float(t_len)
    if cov_mode == 0:    # bidirectional
        return q / t >= cov_thr and t / q >= cov_thr
    if cov_mode == 1:    # target coverage
        return q / t >= cov_thr
    if cov_mode == 2:    # query coverage
        return t / q >= cov_thr
    if cov_mode == 3:    # length of query
        return cov_thr <= t / q <= 1.0
    if cov_mode == 4:    # length of target
        return cov_thr <= q / t <= 1.0
    if cov_mode == 5:    # length of shorter
        return min(q, t) / max(q, t) >= cov_thr
    return True
