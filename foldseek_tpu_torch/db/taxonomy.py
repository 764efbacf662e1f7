"""NCBI taxonomy support — per-entry taxid mappings and the taxonomy output
columns (reference: lib/mmseqs/src/taxonomy/NcbiTaxonomy.cpp, surfaced in
foldseek through createdb --tax-mapping-file and convertalis taxid/taxname/
taxlineage columns).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

from ..utils.log import logger


class NcbiTaxonomy:
    """Minimal NCBI taxdump reader: nodes.dmp (id -> parent, rank) and
    names.dmp (scientific names); provides names, lineages, and LCA."""

    def __init__(self, taxdump_dir: str):
        self.parent: Dict[int, int] = {}
        self.rank: Dict[int, str] = {}
        self.name: Dict[int, str] = {}
        with open(os.path.join(taxdump_dir, "nodes.dmp")) as f:
            for line in f:
                parts = [p.strip() for p in line.split("|")]
                tid, parent, rank = int(parts[0]), int(parts[1]), parts[2]
                self.parent[tid] = parent
                self.rank[tid] = rank
        with open(os.path.join(taxdump_dir, "names.dmp")) as f:
            for line in f:
                parts = [p.strip() for p in line.split("|")]
                if len(parts) > 3 and parts[3] == "scientific name":
                    self.name[int(parts[0])] = parts[1]
        logger.info("taxonomy: %d nodes, %d names", len(self.parent), len(self.name))

    def lineage(self, taxid: int) -> List[int]:
        out = []
        seen = set()
        while taxid in self.parent and taxid not in seen and taxid != 1:
            out.append(taxid)
            seen.add(taxid)
            taxid = self.parent[taxid]
        out.append(1)
        return out[::-1]

    def lineage_str(self, taxid: int) -> str:
        parts = []
        for t in self.lineage(taxid):
            r = self.rank.get(t, "no rank")
            prefix = {"superkingdom": "d_", "kingdom": "k_", "phylum": "p_",
                      "class": "c_", "order": "o_", "family": "f_",
                      "genus": "g_", "species": "s_"}.get(r)
            if prefix:
                parts.append(prefix + self.name.get(t, str(t)))
        return ";".join(parts)

    def lca(self, taxids: List[int]) -> int:
        """Lowest common ancestor of a set of taxa."""
        taxids = [t for t in taxids if t in self.parent]
        if not taxids:
            return 0
        common = None
        for t in taxids:
            lin = set(self.lineage(t))
            common = lin if common is None else (common & lin)
        if not common:
            return 1
        # deepest node among the common ancestors
        best = max(common, key=lambda t: len(self.lineage(t)))
        return best


def load_tax_mapping(path: str) -> Dict[str, int]:
    """Entry-name (or accession) -> taxid TSV (the reference's _mapping)."""
    out = {}
    for line in open(path):
        parts = line.rstrip("\n").split("\t")
        if len(parts) >= 2:
            try:
                out[parts[0]] = int(parts[1])
            except ValueError:
                continue
    return out


def db_taxids(db, mapping: Dict[str, int]) -> Dict[int, int]:
    """Per-entry taxid by matching entry name, its complex prefix, or the
    source file name against the mapping."""
    out = {}
    for i in range(db.size):
        name = db.names[i]
        tid = mapping.get(name)
        if tid is None and "_" in name:
            tid = mapping.get(name[:name.rfind("_")])
        if tid is None and db.sources is not None and db.fileids is not None:
            fid = int(db.fileids[i])
            if fid < len(db.sources):
                tid = mapping.get(db.sources[fid])
        out[int(db.keys[i])] = tid if tid is not None else 0
    return out


def save_db_mapping(db, mapping: Dict[str, int]):
    taxids = db_taxids(db, mapping)
    with open(os.path.join(db.path, "mapping.tsv"), "w") as f:
        for i in range(db.size):
            key = int(db.keys[i])
            f.write(f"{key}\t{taxids[key]}\n")


def load_db_mapping(db_path: str) -> Optional[Dict[int, int]]:
    path = os.path.join(db_path, "mapping.tsv")
    if not os.path.isfile(path):
        return None
    out = {}
    for line in open(path):
        k, t = line.split("\t")
        out[int(k)] = int(t)
    return out


# --- LCA assignment (lib/mmseqs/src/taxonomy/lca.cpp, NcbiTaxonomy.cpp) ---

# NcbiRanks (NcbiTaxonomy.h:52-79): ordinal per named rank, used to pick
# the lowest-rank majority candidate
NCBI_RANKS = {
    "forma": 1, "varietas": 2, "subspecies": 3, "species": 4,
    "species subgroup": 5, "species group": 6, "subgenus": 7, "genus": 8,
    "subtribe": 9, "tribe": 10, "subfamily": 11, "family": 12,
    "superfamily": 13, "parvorder": 14, "infraorder": 15, "suborder": 16,
    "order": 17, "superorder": 18, "infraclass": 19, "subclass": 20,
    "class": 21, "superclass": 22, "subphylum": 23, "phylum": 24,
    "superphylum": 25, "subkingdom": 26, "kingdom": 27, "superkingdom": 28}
ROOT_RANK = 1 << 31
MAX_TAX_WEIGHT = 1000.0

VOTE_UNIFORM = 0       # AGG_TAX_UNIFORM
VOTE_MINUS_LOG_EVAL = 1
VOTE_SCORE = 2


def hit_weight(value: float, vote_mode: int) -> float:
    """WeightedTaxHit (NcbiTaxonomy.cpp:598-620)."""
    if vote_mode == VOTE_UNIFORM:
        return 1.0
    if vote_mode == VOTE_MINUS_LOG_EVAL:
        import math
        if value > 0:
            return -math.log(value)
        return MAX_TAX_WEIGHT
    return value


class _AncNode:
    __slots__ = ("weight", "is_candidate", "child")

    def __init__(self, weight, is_candidate, child):
        self.weight = weight
        self.is_candidate = is_candidate
        self.child = child

    def update(self, w, child):
        if self.child != child:
            self.is_candidate = True
            self.child = child
        self.weight += w


def _min_rank_index(tax: NcbiTaxonomy, taxid: int) -> int:
    """Lowest named-rank ordinal on the path from taxid to the root
    (weightedMajorityLCA's currMinRank walk)."""
    cur = taxid
    while True:
        idx = NCBI_RANKS.get(tax.rank.get(cur, ""), -1)
        if idx > 0:
            return idx
        parent = tax.parent.get(cur, cur)
        if parent == cur:
            return ROOT_RANK
        cur = parent


def weighted_majority_lca(tax: NcbiTaxonomy, taxa_weights, majority_thr: float) -> int:
    """NcbiTaxonomy::weightedMajorityLCA (NcbiTaxonomy.cpp:622-719):
    accumulate each hit's weight on its full ancestor path; among CANDIDATE
    nodes (nodes reached from more than one child, or hit directly) meeting
    the majority cutoff, pick the lowest named rank (ties: higher share)."""
    counts = {}
    total = 0.0
    for taxid, w in taxa_weights:
        if taxid == 0 or taxid not in tax.parent:
            continue
        total += w
        cur = taxid
        node = counts.get(cur)
        if node is not None:
            node.update(w, 0)
        else:
            counts[cur] = _AncNode(w, True, 0)
        parent = tax.parent.get(cur, cur)
        while parent != cur:
            node = counts.get(parent)
            if node is not None:
                node.update(w, cur)
            else:
                counts[parent] = _AncNode(w, False, cur)
            cur = parent
            parent = tax.parent.get(cur, cur)
    if total == 0:
        return 0
    selected = 0
    min_rank = ROOT_RANK + 1
    sel_pct = 0.0
    for taxid, node in counts.items():
        if not node.is_candidate:
            continue
        pct = node.weight / total
        if pct >= majority_thr:
            r = _min_rank_index(tax, taxid)
            if r < min_rank or (r == min_rank and pct > sel_pct):
                selected = taxid
                min_rank = r
                sel_pct = pct
    return selected


def is_ancestor(tax: NcbiTaxonomy, anc: int, taxid: int) -> bool:
    cur = taxid
    seen = set()
    while cur in tax.parent and cur not in seen:
        if cur == anc:
            return True
        seen.add(cur)
        cur = tax.parent[cur]
    return cur == anc


class TaxonomyExpression:
    """--taxon-list expressions (TaxonomyExpression.h): a plain taxid, a
    comma list (OR), or a boolean expression over taxids with !, &&, ||,
    parentheses — each number means "is the hit's taxon under this
    ancestor"."""

    def __init__(self, expression: str, tax: NcbiTaxonomy):
        self.tax = tax
        self.expr = expression.strip()

    def matches(self, taxid: int) -> bool:
        import re
        e = self.expr
        if e.isdigit():
            return is_ancestor(self.tax, int(e), taxid)
        e = e.replace(",", " or ")
        e = e.replace("&&", " and ").replace("||", " or ").replace("!", " not ")
        e = re.sub(r"\d+",
                   lambda m: str(is_ancestor(self.tax, int(m.group()), taxid)),
                   e)
        if not re.fullmatch(r"[ ()TFaedlnorstu]+", e):
            raise ValueError(f"invalid taxon expression: {self.expr!r}")
        return bool(eval(e, {"__builtins__": {}}, {}))  # sanitized above


def lca_assign(tax: NcbiTaxonomy, hits_per_query, mapping,
               vote_mode: int = VOTE_UNIFORM, majority: float = 0.0,
               blacklist=(), ranks=(), show_lineage: int = 0):
    """Per-query taxonomic assignment lines (lca.cpp main loop).

    hits_per_query: qkey -> [(target_key, weight_value)] where weight_value
    is the e-value (vote mode 1) or score (mode 2); mapping: target key ->
    taxid. Returns qkey -> TSV line `taxid\\trank\\tname[...]`."""
    out = {}
    for qkey, hits in hits_per_query.items():
        weighted = []
        taxa = []
        for tkey, val in hits:
            taxon = mapping.get(int(tkey), 0)
            if taxon == 0:
                continue
            if any(b and is_ancestor(tax, b, taxon) for b in blacklist):
                continue
            if majority > 0:
                weighted.append((taxon, hit_weight(val, vote_mode)))
            else:
                taxa.append(taxon)
        if majority > 0:
            node = weighted_majority_lca(tax, weighted, majority)
        else:
            node = tax.lca(taxa) if taxa else 0
        if node == 0 or node not in tax.parent:
            out[int(qkey)] = "0\tno rank\tunclassified"
            continue
        cols = [str(node), tax.rank.get(node, "no rank"),
                tax.name.get(node, str(node))]
        if ranks:
            at = {tax.rank.get(t, ""): tax.name.get(t, str(t))
                  for t in tax.lineage(node)}
            cols.append(";".join(at.get(r, "-") for r in ranks))
        if show_lineage == 1:
            cols.append(tax.lineage_str(node))
        elif show_lineage == 2:
            cols.append(";".join(str(t) for t in tax.lineage(node)))
        out[int(qkey)] = "\t".join(cols)
    return out
