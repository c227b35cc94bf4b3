"""Reference ScannConfig text protos -> the port's builder.

Port of scann_tpu/utils/config_text.py.  Users of the reference library
hold ScannConfig TEXT protos (what its scann_builder.create_config emits
and its docs show).  ``builder_from_pbtxt(db, text, device)`` parses one
and canonicalizes it onto scann_torch's builder with the JAX package's
rules (the reference's scann_config_utils.cc canonicalization role), so
a reference config migrates with one call::

    searcher = scann_torch.searcher_from_pbtxt(db, open("cfg.pbtxt").read())

Parsing is a self-contained reader of the textproto subset the ScannConfig
grammar uses (``key: value``, ``key { ... }``, repeated keys, strings,
enums, ``#`` comments).  Canonicalization:
  * ``use_residual_quantization`` / ``use_global_topn`` are derived (tree
    + dot product => residual), not read;
  * legacy ``fixed_point { enabled: true }`` / ``bfloat16 { enabled:
    true }`` stanzas map to the quantize names;
  * fields that do not change search semantics
    (``fixed_point_lut_conversion_options``, ``quantization_distance``,
    ``partitioning_distance``, ``query_tokenization_distance_override``)
    are accepted and ignored;
  * a legacy autopilot stanza selects the reference heuristics.
"""

from __future__ import annotations

import math
import re
from typing import Any

_TOKEN = re.compile(r"""
    (?P<comment>\#[^\n]*)
  | (?P<brace>[{}])
  | (?P<colon>:)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<word>[^\s{}:"#]+)
""", re.VERBOSE)


def _tokens(text: str):
    for m in _TOKEN.finditer(text):
        kind = m.lastgroup
        if kind != "comment":
            yield kind, m.group()


def _typed(word: str) -> Any:
    low = word.lower()
    if low in ("true", "false"):
        return low == "true"
    if low == "nan":
        return float("nan")
    try:
        return int(word)
    except ValueError:
        pass
    try:
        return float(word)
    except ValueError:
        return word  # enum name


def parse_textproto(text: str) -> dict:
    """Textproto subset -> nested dict; repeated keys become lists."""
    toks = list(_tokens(text))
    pos = 0

    def store(d, key, val):
        if key in d:
            if not isinstance(d[key], list):
                d[key] = [d[key]]
            d[key].append(val)
        else:
            d[key] = val

    def message(nested=False):
        nonlocal pos
        out = {}
        while pos < len(toks):
            kind, tok = toks[pos]
            if kind == "brace" and tok == "}":
                if not nested:
                    raise ValueError("unbalanced '}' in config text")
                pos += 1
                return out
            if kind not in ("word", "string"):
                raise ValueError(f"expected field name, got {tok!r}")
            key = tok
            pos += 1
            kind, tok = toks[pos] if pos < len(toks) else ("", "")
            if kind == "colon":
                pos += 1
                kind, tok = toks[pos]
                if kind == "brace" and tok == "{":  # "key: { ... }"
                    pos += 1
                    store(out, key, message(nested=True))
                elif kind == "string":
                    pos += 1
                    store(out, key, tok[1:-1])
                elif kind == "word":
                    pos += 1
                    store(out, key, _typed(tok))
                else:
                    raise ValueError(f"bad value for {key}: {tok!r}")
            elif kind == "brace" and tok == "{":
                pos += 1
                store(out, key, message(nested=True))
            else:
                raise ValueError(f"expected ':' or '{{' after {key}")
        if nested:
            raise ValueError("unbalanced braces in config text")
        return out

    return message()


_MEASURES = {
    "DotProductDistance": "dot_product",
    "SquaredL2Distance": "squared_l2",
    "CosineDistance": "cosine",
    "L1Distance": "l1",
}

_SPILL_TYPES = {
    "NO_SPILLING": "fixed_number",
    "FIXED_NUMBER_OF_CENTERS": "fixed_number",
    "ADDITIVE": "additive",
    "MULTIPLICATIVE": "multiplicative",
    "ABSOLUTE_DISTANCE": "absolute_distance",
}


def _as_list(v):
    return v if isinstance(v, list) else [v]


def _quantize_of(stanza: dict) -> str:
    """{fixed_point{enabled}} / {bfloat16{enabled}} -> quantize name."""
    fp = stanza.get("fixed_point", {})
    bf = stanza.get("bfloat16", {})
    if isinstance(bf, dict) and bf.get("enabled"):
        return "bfloat16"
    if isinstance(fp, dict) and fp.get("enabled"):
        return "int8"
    return "float32"


def builder_from_pbtxt(db, text: str, device="cuda"):
    """Reference ScannConfig textproto -> a configured scann_torch builder
    on ``device``.  Call ``.build()`` on the result (or use
    ``scann_torch.searcher_from_pbtxt``)."""
    import scann_torch

    d = parse_textproto(text)
    if "num_neighbors" not in d:
        raise ValueError("config text has no num_neighbors")
    dm = d.get("distance_measure", {})
    name = (dm.get("distance_measure", "DotProductDistance")
            if isinstance(dm, dict) else str(dm))
    measure = _MEASURES.get(name)
    if measure is None:
        raise ValueError(f"unsupported distance_measure {name!r} "
                         f"(known: {sorted(_MEASURES)})")
    b = scann_torch.builder(db, int(d["num_neighbors"]), measure,
                          device=device)

    ap = d.get("autopilot")
    if ap is not None:
        ta = ap.get("tree_ah", {})
        mode = {"NONE": None, "ONLINE": "online",
                "ONLINE_INCREMENTAL": "online_incremental"}[
                    ta.get("incremental_mode", "NONE")]
        quant = {"FLOAT32": "float32", "INT8": "int8",
                 "BFLOAT16": "bfloat16"}[
                     ta.get("reordering_dtype", "FLOAT32")]
        # A legacy autopilot config means reference heuristics.
        return b.autopilot(mode=mode, quantize=quant,
                           heuristics="reference")

    p = d.get("partitioning")
    if p is not None:
        qs = p.get("query_spilling", {})
        spill = _SPILL_TYPES.get(
            qs.get("spilling_type", "FIXED_NUMBER_OF_CENTERS"))
        if spill is None:
            raise ValueError(
                f"unknown query spilling_type {qs.get('spilling_type')!r}")
        kw = dict(
            num_leaves=int(p["num_children"]),
            num_leaves_to_search=int(qs.get("max_spill_centers", 1)),
            training_sample_size=int(p.get("expected_sample_size",
                                           100_000)),
            min_partition_size=int(p.get("min_cluster_size", 50)),
            training_iterations=int(p.get("max_clustering_iterations", 12)),
            spherical=p.get("partitioning_type") == "SPHERICAL",
            random_init=p.get("single_machine_center_initialization",
                              "RANDOM_INITIALIZATION")
            == "RANDOM_INITIALIZATION",
            quantize_centroids=p.get("query_tokenization_type")
            == "FIXED_POINT_INT8",
        )
        if spill != "fixed_number":
            kw["query_spilling_type"] = spill
            if "spilling_threshold" in qs:
                kw["query_spilling_threshold"] = float(
                    qs["spilling_threshold"])
        it = p.get("incremental_training_config")
        if isinstance(it, dict):
            if "number_of_datapoints" in it:
                kw["incremental_threshold"] = int(it["number_of_datapoints"])
            elif "fraction" in it:
                kw["incremental_threshold"] = float(it["fraction"])
        if "avq" in p and not (isinstance(p["avq"], float)
                               and math.isnan(p["avq"])):
            kw["avq"] = float(p["avq"])
        dsp = p.get("database_spilling")
        if (isinstance(dsp, dict) and dsp.get("spilling_type")
                == "TWO_CENTER_ORTHOGONALITY_AMPLIFIED"):
            kw["soar_lambda"] = float(
                dsp.get("orthogonality_amplification_lambda", 1.5))
            if "overretrieve_factor" in dsp:
                kw["overretrieve_factor"] = float(dsp["overretrieve_factor"])
        b.tree(**kw)
        proj = p.get("projection")
        if isinstance(proj, dict):
            ptype = proj.get("projection_type")
            if ptype == "PCA":
                if "num_dims_per_block" in proj:
                    b.pca(reduction_dim=int(proj["num_dims_per_block"]),
                          pca_significance_threshold=None)
                else:
                    b.pca(pca_significance_threshold=float(
                        proj.get("pca_significance_threshold", 0.8)),
                        pca_truncation_threshold=float(
                            proj.get("pca_truncation_threshold", 0.6)))
            elif ptype == "TRUNCATE":
                b.truncate(int(proj["num_dims_per_block"]))
            else:
                raise ValueError(
                    f"unsupported partitioning projection {ptype!r}")
        ut = p.get("bottom_up_top_level_partitioner")
        if isinstance(ut, dict) and ut.get("enabled"):
            soar = ut.get("soar", {})
            b.upper_tree(
                int(ut["num_centroids"]),
                int(ut["num_centroids_to_search"]),
                avq=float(ut.get("avq", float("nan"))),
                soar_lambda=(float(soar.get("lambda", 1.5))
                             if isinstance(soar, dict)
                             and soar.get("enabled") else None),
                scoring_mode={"FIXED8": "int8", "BFLOAT16": "bfloat16",
                              "FLOAT32": "float32"}.get(
                                  ut.get("quantization", "FIXED8"), "int8"))

    ah = d.get("hash", {})
    ah = ah.get("asymmetric_hash") if isinstance(ah, dict) else None
    bf = d.get("brute_force")
    if ah is not None:
        lookup = ah.get("lookup_type", "INT8_LUT16")
        hash_type = {"INT8_LUT16": "lut16", "INT8": "lut256",
                     "FLOAT": "lut256"}.get(lookup)
        if hash_type is None:
            raise ValueError(f"unsupported AH lookup_type {lookup!r}")
        proj = ah.get("projection", {})
        kw = dict(hash_type=hash_type)
        vb = proj.get("variable_blocks")
        if vb is not None:
            widths = []
            for blk in _as_list(vb):
                widths += ([int(blk["num_dims_per_block"])]
                           * int(blk["num_blocks"]))
            kw["variable_dims_per_block"] = widths
            dpb = max(widths)
        else:
            dpb = int(proj.get("num_dims_per_block", 2))
        t = ah.get("noise_shaping_threshold", float("nan"))
        b.score_ah(dpb, anisotropic_quantization_threshold=float(t),
                   training_sample_size=int(
                       ah.get("expected_sample_size", 100_000)),
                   training_iterations=int(
                       ah.get("max_clustering_iterations", 10)), **kw)
    elif bf is not None:
        b.score_brute_force(quantize=_quantize_of(bf))
    else:
        raise ValueError("config text has neither hash.asymmetric_hash "
                         "nor brute_force")

    er = d.get("exact_reordering")
    if isinstance(er, dict):
        t = float("nan")
        fp = er.get("fixed_point")
        if isinstance(fp, dict) and "noise_shaping_threshold" in fp:
            t = float(fp["noise_shaping_threshold"])
        b.reorder(int(er.get("approx_num_neighbors",
                             int(d["num_neighbors"]))),
                  quantize=_quantize_of(er),
                  anisotropic_quantization_threshold=t)
    return b


def searcher_from_pbtxt(db, text: str, device="cuda"):
    """Build a searcher on ``device`` straight from a reference ScannConfig
    textproto."""
    return builder_from_pbtxt(db, text, device).build()
