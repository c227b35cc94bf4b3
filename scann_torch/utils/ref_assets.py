"""Reference-format index directories: read and write them.

Port of scann_tpu/utils/ref_assets.py.  The reference library serializes
an index as a ``scann_assets.pbtxt`` manifest plus one file an asset
(ScannInterface::Serialize, scann_ops/cc/scann.cc; schema
scann_ops/scann_assets.proto):

  scann_config.pb             binary ScannConfig        (proto/scann.proto)
  ah_codebook.pb              CentersForAllSubspaces    (proto/centers.proto)
  serialized_partitioner.pb   SerializedPartitioner     (partitioning/partitioner.proto)
  datapoint_to_token.npy      int32 (n,) or, under SOAR, (2n,) interleaved
                              slot tokens with -1 empty sentinel
  hashed_dataset.npy          uint8 (n, num_blocks) AH codes
  hashed_dataset_soar.npy     uint8 (n, num_blocks) secondary-slot codes
  int8_dataset.npy / int8_multipliers.npy / dp_norms.npy
  bfloat16_dataset.npy        int16 bit-pattern view
  dataset.npy                 float32 raw rows (exact reordering)

The protos involved are small, so the wire codec below is written out
(protobuf wire format: varint / 64-bit / length-delimited / 32-bit) and
maps only the fields the reference loader consumes; it is the JAX
package's, so both packages write the same bytes.

``load_reference_assets(dir, device)`` -> a live searcher on ``device``
(TreeAHSearcher for tree-AH configs, BruteForceSearcher for brute-force
configs) from the trained assets, with no retraining, through the port's
own loader (utils/serialization.py).  ``save_reference_assets(searcher,
dir)`` -> a directory the reference's ``load_searcher`` reads.  The
golden fixtures tests/data/golden_*.pb pin the codec to the reference
proto schemas.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pickle
import struct

import numpy as np
import torch

from scann_torch import config as cfg

# ---------------------------------------------------------------------------
# Protobuf wire codec (proto2/proto3 wire format).
# Wire types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32.

_WT_VARINT, _WT_F64, _WT_LEN, _WT_F32 = 0, 1, 2, 5


def _read_varint(buf: bytes, i: int):
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def decode_message(buf: bytes) -> dict:
    """Decode one message into {field_number: [(wire_type, value), ...]}.
    Varints decode to int; fixed32/64 to raw 4/8 bytes; LEN to bytes."""
    fields: dict = {}
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == _WT_VARINT:
            val, i = _read_varint(buf, i)
        elif wt == _WT_F64:
            val, i = buf[i:i + 8], i + 8
        elif wt == _WT_LEN:
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wt == _WT_F32:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {field})")
        fields.setdefault(field, []).append((wt, val))
    return fields


def _gi(msg, f, default=None):
    """Last varint value of field f (proto2 last-wins)."""
    vals = msg.get(f)
    return vals[-1][1] if vals else default


def _gsigned(msg, f, default=None):
    """int32 fields carrying negatives are varint-encoded from the 64-bit
    two's complement."""
    v = _gi(msg, f, None)
    if v is None:
        return default
    return v - (1 << 64) if v >= (1 << 63) else v


def _gf(msg, f, default=None):
    vals = msg.get(f)
    if not vals:
        return default
    wt, raw = vals[-1]
    return struct.unpack("<f", raw)[0] if wt == _WT_F32 else default


def _gd(msg, f, default=None):
    vals = msg.get(f)
    if not vals:
        return default
    wt, raw = vals[-1]
    return struct.unpack("<d", raw)[0] if wt == _WT_F64 else default


def _gm(msg, f):
    vals = msg.get(f)
    return decode_message(vals[-1][1]) if vals else None


def _gms(msg, f):
    return [decode_message(raw) for _, raw in msg.get(f, [])]


def _gs(msg, f, default=None):
    vals = msg.get(f)
    return vals[-1][1].decode() if vals else default


def _packed(msg, f, fmt, width):
    """Packed repeated scalar field -> numpy array (accepts the unpacked
    per-element encoding too)."""
    chunks = []
    for wt, raw in msg.get(f, []):
        if wt == _WT_LEN:
            chunks.append(np.frombuffer(raw, dtype=fmt))
        else:
            chunks.append(np.array([struct.unpack(
                "<" + ("f" if width == 4 else "d"), raw)[0]], dtype=fmt))
    if not chunks:
        return np.zeros((0,), fmt)
    return np.concatenate(chunks)


def _e_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _e_field(field: int, wt: int, payload) -> bytes:
    tag = _e_varint((field << 3) | wt)
    if wt == _WT_VARINT:
        return tag + _e_varint(payload)
    if wt == _WT_LEN:
        return tag + _e_varint(len(payload)) + payload
    return tag + payload  # fixed32/64: payload already raw bytes


def _e_f32(field: int, v: float) -> bytes:
    return _e_field(field, _WT_F32, struct.pack("<f", v))


def _e_f64(field: int, v: float) -> bytes:
    return _e_field(field, _WT_F64, struct.pack("<d", v))


def _e_packed_f64(field: int, arr) -> bytes:
    return _e_field(field, _WT_LEN,
                    np.asarray(arr, "<f8").tobytes())


def _e_str(field: int, s: str) -> bytes:
    return _e_field(field, _WT_LEN, s.encode())


# ---------------------------------------------------------------------------
# scann_assets.pbtxt manifest (textproto of ScannAssets).

_ASSET_TYPES = {  # scann_assets.proto:21-46
    "DATASET_NPY": 9, "INT8_DATASET_NPY": 10, "AH_DATASET_NPY": 11,
    "TOKENIZATION_NPY": 12, "INT8_MULTIPLIERS_NPY": 13,
    "INT8_NORMS_NPY": 14, "BF16_DATASET_NPY": 15, "AH_DATASET_SOAR_NPY": 16,
    "AH_CENTERS": 7, "PARTITIONER": 8,
}


def parse_assets_pbtxt(text: str):
    """Parse the scann_assets.pbtxt manifest -> [(type_name, path), ...]."""
    out = []
    cur_type = cur_path = None
    depth = 0
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("assets") and line.endswith("{"):
            depth, cur_type, cur_path = 1, None, None
        elif line == "}" and depth == 1:
            if cur_type is not None and cur_path is not None:
                out.append((cur_type, cur_path))
            depth = 0
        elif depth == 1 and line.startswith("asset_type:"):
            cur_type = line.split(":", 1)[1].strip()
        elif depth == 1 and line.startswith("asset_path:"):
            cur_path = line.split(":", 1)[1].strip().strip('"')
    return out


def emit_assets_pbtxt(assets) -> str:
    lines = []
    for type_name, path in assets:
        lines += ["assets {", f"  asset_type: {type_name}",
                  f'  asset_path: "{path}"', "}"]
    lines.append("trained_on_the_fly: false")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# ScannConfig (proto/scann.proto) <-> the config dataclasses.

# QuerySpillingConfig.SpillingType (proto/partitioning.proto)
_QS_FIXED_NUMBER = 4
# DatabaseSpillingConfig.SpillingType
_DS_SOAR = 4
# AsymmetricHasherConfig.LookupType (proto/hash.proto)
_LOOKUP = {0: "float32", 1: "int8", 2: "int8", 3: "int8"}


def decode_scann_config(buf: bytes) -> cfg.ScannConfig:
    """Map the reference ScannConfig fields the loader consumes onto the
    config dataclasses (field numbers from proto/scann.proto and its
    sub-protos)."""
    msg = decode_message(buf)
    num_neighbors = _gi(msg, 3, 10)  # num_neighbors = 3

    dist = _gm(msg, 5)  # distance_measure = 5
    name = _gs(dist, 1, "SquaredL2Distance") if dist else "SquaredL2Distance"
    measure = {
        "DotProductDistance": cfg.DOT_PRODUCT,
        "SquaredL2Distance": cfg.SQUARED_L2,
        "CosineDistance": cfg.COSINE,
    }.get(name)
    if measure is None:
        raise ValueError(f"unsupported reference distance measure {name!r}")
    pc_out = ac_out = bf_out = rc_out = None

    part = _gm(msg, 8)  # partitioning = 8
    if part:
        kw = dict(
            num_leaves=_gi(part, 3, 0),            # num_children = 3
            training_iterations=_gi(part, 6, 10),  # max_clustering_iterations
            training_sample_size=_gi(part, 45, 100000),  # expected_sample
            spherical=_gi(part, 23, 0) == 1,       # partitioning_type
            random_init=_gi(part, 49, 0) == 1,     # center initialization
            quantize_centroids=_gi(part, 28, 1) == 2)  # FIXED_POINT_INT8
        avq = _gf(part, 51)                        # avq = 51, default nan
        if avq is not None and not math.isnan(avq):
            kw["avq"] = avq
        qs = _gm(part, 21)  # query_spilling = 21
        if qs:
            kw["num_leaves_to_search"] = _gi(qs, 3, 1)  # max_spill_centers
            qs_type = _gi(qs, 1, 0)  # QuerySpillingConfig.SpillingType
            named = {1: "multiplicative", 2: "additive",
                     3: "absolute_distance"}.get(qs_type)
            if named is not None:
                kw["query_spilling_type"] = named
                kw["query_spilling_threshold"] = _gf(qs, 2)
        ds = _gm(part, 20)  # database_spilling = 20
        if ds and _gi(ds, 1, 0) == _DS_SOAR:
            kw["soar"] = cfg.SoarConfig(
                lambda_=_gf(ds, 4, 1.5),          # orthogonality λ = 4
                overretrieve_factor=_gf(ds, 5, 2.0))
        pc_out = cfg.PartitioningConfig(**kw)

    hash_cfg = _gm(msg, 13)  # hash = 13
    ah = _gm(hash_cfg, 5) if hash_cfg else None  # asymmetric_hash = 5
    if ah:
        clusters = _gi(ah, 2, 256)  # num_clusters_per_block = 2
        kw = dict(
            hash_type="lut16" if clusters == 16 else "lut256",
            lookup_type=_LOOKUP[_gi(ah, 20, 0)],  # lookup_type = 20
            residual_quantization=_gi(ah, 22, 0) == 1,
            training_sample_size=_gi(ah, 29, 100000),
            training_iterations=_gi(ah, 4, 10))
        thr = _gd(ah, 28)  # noise_shaping_threshold = 28
        if thr is not None:
            kw["anisotropic_quantization_threshold"] = thr
        proj = _gm(ah, 1)  # projection = 1
        if proj and _gi(proj, 3):
            kw["dimensions_per_block"] = _gi(proj, 3)  # num_dims_per_block
        lut_opts = _gm(ah, 25)  # fixed_point_lut_conversion_options
        if lut_opts:
            kw["lut_multiplier_quantile"] = _gf(lut_opts, 2, 1.0)
        ac_out = cfg.AsymmetricHashConfig(**kw)

    bf = _gm(msg, 7)  # brute_force = 7
    if bf is not None and ah is None:
        fp = _gm(bf, 4)  # BruteForceConfig.fixed_point = 4
        b16 = _gm(bf, 5)  # BruteForceConfig.bfloat16 = 5
        quantize = cfg.FLOAT32
        if fp and _gi(fp, 1, 0) == 1:
            quantize = cfg.INT8
        elif b16 and _gi(b16, 1, 0) == 1:
            quantize = cfg.BFLOAT16
        bf_out = cfg.BruteForceConfig(quantize=quantize)
    if ac_out is None and bf_out is None:
        bf_out = cfg.BruteForceConfig()

    reo = _gm(msg, 17)  # exact_reordering = 17
    if reo:
        kw = dict(reordering_num_neighbors=_gi(reo, 1, 100))
        fp = _gm(reo, 5)  # fixed_point = 5
        b16 = _gm(reo, 7)  # bfloat16 = 7
        if fp and _gi(fp, 1, 0) == 1:
            kw["quantize"] = cfg.INT8
            thr = _gd(fp, 8)  # noise_shaping_threshold = 8
            if thr is not None:
                kw["anisotropic_quantization_threshold"] = thr
            # Reference int8 reordering quantizes absolute rows.
            kw["residual"] = False
        elif b16 and _gi(b16, 1, 0) == 1:
            kw["quantize"] = cfg.BFLOAT16
        rc_out = cfg.ReorderConfig(**kw)
    return cfg.ScannConfig(
        num_neighbors=num_neighbors, distance_measure=measure,
        partitioning=pc_out, asymmetric_hash=ac_out, brute_force=bf_out,
        reordering=rc_out)


def encode_scann_config(config: cfg.ScannConfig) -> bytes:
    """Config -> the binary ScannConfig the reference factory reads."""
    parts = [_e_field(3, _WT_VARINT, config.num_neighbors)]
    dist_name = {cfg.DOT_PRODUCT: "DotProductDistance",
                 cfg.SQUARED_L2: "SquaredL2Distance",
                 cfg.COSINE: "CosineDistance"}.get(config.distance_measure)
    if dist_name is None:
        raise ValueError(
            f"distance {config.distance_measure!r} has no reference-format "
            "equivalent")
    parts.append(_e_field(5, _WT_LEN, _e_str(1, dist_name)))

    pc = config.partitioning
    if pc is not None:
        sub = [_e_field(3, _WT_VARINT, pc.num_leaves),
               _e_field(6, _WT_VARINT, pc.training_iterations),
               _e_field(45, _WT_VARINT, pc.training_sample_size),
               _e_field(23, _WT_VARINT, 1 if pc.spherical else 0),
               _e_field(49, _WT_VARINT, 1 if pc.random_init else 0),
               _e_field(28, _WT_VARINT,
                        2 if pc.quantize_centroids else 1),
               _e_field(29, _WT_VARINT,
                        2 if pc.quantize_centroids else 1)]
        if pc.avq is not None:
            sub.append(_e_f32(51, pc.avq))
        qs_num = {"multiplicative": 1, "additive": 2,
                  "absolute_distance": 3}.get(pc.query_spilling_type)
        if qs_num is not None:
            qs = [_e_field(1, _WT_VARINT, qs_num),
                  _e_f32(2, pc.query_spilling_threshold or 0.0),
                  _e_field(3, _WT_VARINT, pc.num_leaves_to_search)]
        else:
            qs = [_e_field(1, _WT_VARINT, _QS_FIXED_NUMBER),
                  _e_field(3, _WT_VARINT, pc.num_leaves_to_search)]
        sub.append(_e_field(21, _WT_LEN, b"".join(qs)))
        if pc.soar is not None:
            ds = [_e_field(1, _WT_VARINT, _DS_SOAR),
                  _e_f32(4, pc.soar.lambda_),
                  _e_f32(5, pc.soar.overretrieve_factor)]
            sub.append(_e_field(20, _WT_LEN, b"".join(ds)))
        parts.append(_e_field(8, _WT_LEN, b"".join(sub)))

    ac = config.asymmetric_hash
    if ac is not None:
        clusters = 16 if ac.hash_type == "lut16" else 256
        proj = [_e_field(1, _WT_VARINT, 1),  # CHUNK
                _e_field(3, _WT_VARINT, ac.dimensions_per_block)]
        sub = [_e_field(1, _WT_LEN, b"".join(proj)),
               _e_field(2, _WT_VARINT, clusters),
               _e_field(20, _WT_VARINT,
                        3 if (ac.lookup_type != "float32"
                              and clusters == 16)
                        else {"float32": 0}.get(ac.lookup_type, 1)),
               _e_field(22, _WT_VARINT,
                        1 if ac.residual_quantization else 0),
               _e_field(29, _WT_VARINT, ac.training_sample_size),
               _e_field(4, _WT_VARINT, ac.training_iterations)]
        thr = ac.anisotropic_quantization_threshold
        if not math.isnan(thr):
            sub.append(_e_f64(28, thr))
        if ac.lut_multiplier_quantile != 1.0:
            sub.append(_e_field(25, _WT_LEN,
                                _e_f32(2, ac.lut_multiplier_quantile)))
        parts.append(_e_field(13, _WT_LEN, _e_field(5, _WT_LEN,
                                                    b"".join(sub))))
    elif config.brute_force is not None:
        bfc = config.brute_force
        sub = b""
        if bfc.quantize == cfg.INT8:
            sub = _e_field(4, _WT_LEN, _e_field(1, _WT_VARINT, 1))
        elif bfc.quantize == cfg.BFLOAT16:
            sub = _e_field(5, _WT_LEN, _e_field(1, _WT_VARINT, 1))
        parts.append(_e_field(7, _WT_LEN, sub))

    rc = config.reordering
    if rc is not None:
        sub = [_e_field(1, _WT_VARINT, rc.reordering_num_neighbors)]
        if rc.quantize == cfg.INT8:
            fp = [_e_field(1, _WT_VARINT, 1)]
            if not math.isnan(rc.anisotropic_quantization_threshold):
                fp.append(_e_f64(8, rc.anisotropic_quantization_threshold))
            sub.append(_e_field(5, _WT_LEN, b"".join(fp)))
        elif rc.quantize == cfg.BFLOAT16:
            sub.append(_e_field(7, _WT_LEN, _e_field(1, _WT_VARINT, 1)))
        parts.append(_e_field(17, _WT_LEN, b"".join(sub)))
    return b"".join(parts)


# ---------------------------------------------------------------------------
# ah_codebook.pb (CentersForAllSubspaces, proto/centers.proto).

_GFV_FLOAT = 2  # GenericFeatureVector.FeatureType.FLOAT


def decode_codebook(buf: bytes) -> np.ndarray:
    """-> float32 (num_blocks, clusters_per_block, dims_per_block)."""
    msg = decode_message(buf)
    blocks = []
    for sub in _gms(msg, 1):  # subspace_centers = 1
        centers = []
        for gfv in _gms(sub, 1):  # center = 1 (GenericFeatureVector)
            vals = _packed(gfv, 4, "<f4", 4)  # feature_value_float = 4
            if vals.size == 0:
                vals = _packed(gfv, 5, "<f8", 8).astype(np.float32)
            centers.append(vals)
        blocks.append(np.stack(centers))
    return np.stack(blocks).astype(np.float32)


def encode_codebook(codebook: np.ndarray) -> bytes:
    cb = np.asarray(codebook, np.float32)
    out = []
    for block in cb:
        centers = []
        for center in block:
            gfv = (_e_field(1, _WT_VARINT, _GFV_FLOAT)  # feature_type
                   + _e_field(4, _WT_LEN,
                              np.asarray(center, "<f4").tobytes()))
            centers.append(_e_field(1, _WT_LEN, gfv))
        out.append(_e_field(1, _WT_LEN, b"".join(centers)))
    return b"".join(out)


# ---------------------------------------------------------------------------
# serialized_partitioner.pb (SerializedPartitioner -> SerializedKMeansTree).

def _node_centers(node) -> list:
    """A node's per-child centroids (SerializedKMeansTree.Node.centers;
    KMeansTreeNode::CopyToProto, kmeans_tree_node.cc:318-343 — values in
    the packed-double `dimension` field, or `float_dimension`)."""
    out = []
    for c in _gms(node, 1):  # centers = 1
        vals = _packed(c, 1, "<f8", 8)  # dimension = 1 (double)
        if vals.size == 0:
            vals = _packed(c, 2, "<f4", 4)  # float_dimension = 2
        out.append(np.asarray(vals, np.float32))
    return out


def decode_partitioner_tree(buf: bytes):
    """SerializedPartitioner -> (leaf_centers (L, d) f32,
    upper_centers or None, upper_assign or None).

    Flat trees map center i <-> leaf i (KMeansTreeNode::NumberLeaves
    assigns leaf ids in child order).  Two-level trees
    (kmeans_tree.proto Node.children recursion) map the root's centers
    to this repo's upper tree and each internal node's centers to the
    global leaf table at the leaf ids its children carry."""
    msg = decode_message(buf)
    km = _gm(msg, 2)  # kmeans = 2
    if km is None:
        raise ValueError("only KMeansTree partitioners are supported")
    tree = _gm(km, 1)  # kmeans_tree = 1
    root = _gm(tree, 1)  # root = 1
    root_centers = _node_centers(root)
    if not root_centers:
        raise ValueError("partitioner proto has no root centers")
    children = _gms(root, 3)  # children = 3
    if not any(_gms(ch, 3) for ch in children):
        return np.stack(root_centers), None, None
    leaf_centers: dict = {}
    upper_assign: dict = {}
    for ti, ch in enumerate(children):
        grand = _gms(ch, 3)
        if not grand:
            # Uneven depth: a direct leaf under the root keeps the root's
            # centroid for it.
            lid = _gsigned(ch, 5, -1)  # leaf_id = 5
            leaf_centers[lid] = root_centers[ti]
            upper_assign[lid] = ti
            continue
        ccs = _node_centers(ch)
        for j, g in enumerate(grand):
            if _gms(g, 3):
                raise ValueError("k-means trees deeper than two levels "
                                 "are not supported")
            lid = _gsigned(g, 5, -1)
            leaf_centers[lid] = ccs[j]
            upper_assign[lid] = ti
    num_leaves = max(leaf_centers) + 1
    if sorted(leaf_centers) != list(range(num_leaves)):
        raise ValueError("non-contiguous leaf ids in serialized tree")
    centers = np.stack([leaf_centers[i] for i in range(num_leaves)])
    ua = np.asarray([upper_assign[i] for i in range(num_leaves)], np.int32)
    return centers, np.stack(root_centers), ua


def decode_partitioner(buf: bytes) -> np.ndarray:
    """Leaf centroids only, float32 (num_leaves, dims)."""
    return decode_partitioner_tree(buf)[0]


def encode_partitioner(centers: np.ndarray) -> bytes:
    centers = np.asarray(centers, np.float32)
    node_parts = []
    for row in centers:
        node_parts.append(_e_field(1, _WT_LEN, _e_packed_f64(1, row)))
    for i in range(centers.shape[0]):
        # Leaf children carry only their leaf_id (flat tree).
        child = _e_field(5, _WT_VARINT, i)
        node_parts.append(_e_field(3, _WT_LEN, child))
    node_parts.append(_e_field(5, _WT_VARINT, -1))  # root leaf_id = -1
    root = b"".join(node_parts)
    tree = _e_field(1, _WT_LEN, root)
    km = _e_field(1, _WT_LEN, tree)
    return (_e_field(1, _WT_VARINT, centers.shape[0])  # n_tokens
            + _e_field(2, _WT_LEN, km))


# ---------------------------------------------------------------------------
# Directory-level load / save.

def load_reference_assets(artifacts_dir: str, device="cuda"):
    """Reference artifact directory -> a live searcher on ``device`` (no
    retraining; ScannInterface::LoadArtifacts role).  A docid list in
    ``scann_docids.pkl`` travels into the results."""
    from scann_torch.models import base

    dev = base.resolve_device(device)
    with open(os.path.join(artifacts_dir, "scann_config.pb"), "rb") as f:
        config = decode_scann_config(f.read())
    with open(os.path.join(artifacts_dir, "scann_assets.pbtxt")) as f:
        manifest = parse_assets_pbtxt(f.read())

    raw = {}
    for type_name, path in manifest:
        if not os.path.isabs(path):
            path = os.path.join(artifacts_dir, path)
        if path.endswith(".npy"):
            raw[type_name] = np.load(path)
        else:
            with open(path, "rb") as f:
                raw[type_name] = f.read()

    docids = None
    pkl_path = os.path.join(artifacts_dir, "scann_docids.pkl")
    if os.path.exists(pkl_path):
        with open(pkl_path, "rb") as f:
            docids = list(pickle.load(f))

    if config.asymmetric_hash is not None and "AH_CENTERS" in raw:
        config, arrays, meta = _tree_ah_arrays(config, raw)
    else:
        config, arrays, meta = _brute_force_arrays(config, raw)
    return _restore(config, arrays, meta, docids, dev)


def _restore(config, arrays, meta, docids, dev):
    """Build the searcher through the port's loader; bfloat16 rows travel
    as their uint16 bit patterns."""
    from scann_torch.utils import serialization
    meta["dtypes"] = {k: ("bfloat16" if k in ("bf_db", "reorder_db")
                          and np.asarray(v).dtype == np.uint16
                          else str(np.asarray(v).dtype))
                      for k, v in arrays.items()}
    blob = {"config": json.loads(config.to_json()), "meta": meta}
    # Own, writable copies: the searcher's host tables are edited in place
    # by mutation.
    arrays = {k: np.array(v) for k, v in arrays.items()}
    return serialization._restore_searcher(blob, arrays, docids, dev)


def _tree_ah_arrays(config, raw):
    from scann_torch.models import tree_ah
    from scann_torch.utils import native

    codebook = decode_codebook(raw["AH_CENTERS"])
    codes = np.ascontiguousarray(raw["AH_DATASET_NPY"], np.uint8)
    n, num_blocks = codes.shape
    dpb = codebook.shape[2]
    if config.asymmetric_hash.dimensions_per_block != dpb:
        config = dataclasses.replace(config, asymmetric_hash=(
            dataclasses.replace(config.asymmetric_hash,
                                dimensions_per_block=dpb)))

    soar = config.partitioning is not None and config.partitioning.soar
    upper_c = upper_a = None
    if "PARTITIONER" in raw:
        centers, upper_c, upper_a = decode_partitioner_tree(
            raw["PARTITIONER"])
        dims = centers.shape[1]
        if config.partitioning.num_leaves != centers.shape[0]:
            config = dataclasses.replace(config, partitioning=(
                dataclasses.replace(config.partitioning,
                                    num_leaves=centers.shape[0])))
        tok = np.asarray(raw["TOKENIZATION_NPY"], np.int32)
        # Under SOAR the (2n,) tokens interleave: even slot = the row's
        # first token, odd = the other; -1 = empty.
        tok = tok.reshape(n, 2) if soar else tok.reshape(n, 1)
    else:
        # AH without a tree: one implicit leaf.
        dims = codebook.shape[0] * dpb
        centers = None
        tok = np.zeros((n, 1), np.int32)

    slot_codes = [codes]
    slot_leaf = [tok[:, 0]]
    slot_dpid = [np.arange(n, dtype=np.int32)]
    if soar:
        codes2 = np.ascontiguousarray(raw["AH_DATASET_SOAR_NPY"], np.uint8)
        live = tok[:, 1] >= 0
        slot_codes.append(codes2[live])
        slot_leaf.append(tok[live, 1])
        slot_dpid.append(np.arange(n, dtype=np.int32)[live])
    all_codes = np.concatenate(slot_codes, axis=0)
    all_leaf = np.concatenate(slot_leaf).astype(np.int32)
    all_dpid = np.concatenate(slot_dpid).astype(np.int32)

    num_leaves = centers.shape[0] if centers is not None else 1
    order, _ = native.sort_by_leaf(all_leaf, num_leaves)
    all_codes = native.gather_rows_i8(all_codes, order)
    all_leaf = all_leaf[order]
    all_dpid = all_dpid[order]
    s = all_codes.shape[0]
    chunk = tree_ah._slot_chunk(s, recon=False)
    pad = tree_ah._round_up(s, chunk) - s
    if pad:
        all_codes = np.pad(all_codes, ((0, pad), (0, 0)))
        all_leaf = np.pad(all_leaf, (0, pad))
        all_dpid = np.pad(all_dpid, (0, pad), constant_values=-1)

    arrays = {
        "codes": all_codes, "slot_leaf": all_leaf, "slot_dpid": all_dpid,
        "codebook": codebook, "datapoint_to_token": tok,
    }
    if centers is not None:
        arrays["centers"] = centers.astype(np.float32)
        if upper_c is not None:
            arrays["upper_centers"] = upper_c.astype(np.float32)
            arrays["upper_assign"] = np.asarray(upper_a, np.int32)
    config = _attach_reorder_arrays(config, raw, arrays)

    meta = {
        "type": "TreeAHSearcher", "n_points": n, "dims": dims,
        "num_blocks": num_blocks, "model_dims": dims,
        "num_slots": s, "chunk": chunk,
    }
    if upper_c is not None:
        # The reference tree carries no query-time fan-out for its top
        # level: search a quarter of the top centers (the JAX package's
        # default; the caller may retune it).
        meta["upper_leaves_to_search"] = max(1, (len(upper_c) + 3) // 4)
    return config, arrays, meta


def _brute_force_arrays(config, raw):
    arrays = {}
    if "INT8_DATASET_NPY" in raw:
        quantize = cfg.INT8
        db = np.asarray(raw["INT8_DATASET_NPY"], np.int8)
        mult = np.asarray(raw["INT8_MULTIPLIERS_NPY"], np.float32)
        arrays["bf_db"] = db
        arrays["bf_inv_mult"] = 1.0 / mult
        norms = raw.get("INT8_NORMS_NPY")
        if norms is None or len(norms) == 0:
            deq = db.astype(np.float32) / mult[None, :]
            norms = np.sum(deq * deq, axis=1)
        arrays["bf_sq_norms"] = np.asarray(norms, np.float32)
    elif "BF16_DATASET_NPY" in raw:
        quantize = cfg.BFLOAT16
        arrays["bf_db"] = np.asarray(raw["BF16_DATASET_NPY"]).view(
            np.uint16)
        f32 = _bf16_bits_to_f32(arrays["bf_db"])
        arrays["bf_sq_norms"] = np.sum(f32 * f32, axis=1)
    else:
        quantize = cfg.FLOAT32
        arrays["bf_db"] = np.asarray(raw["DATASET_NPY"], np.float32)
    config = dataclasses.replace(
        config, asymmetric_hash=None, partitioning=None,
        brute_force=cfg.BruteForceConfig(quantize=quantize))
    n, dims = arrays["bf_db"].shape
    config = _attach_reorder_arrays(config, raw, arrays)
    return config, arrays, {"type": "BruteForceSearcher", "n_points": n,
                            "dims": dims}


def _attach_reorder_arrays(config, raw, arrays):
    """Fill reorder_* arrays from the manifest; returns the (possibly
    adjusted) config."""
    rc = config.reordering
    if rc is None:
        return config
    if rc.quantize == cfg.INT8 and "INT8_DATASET_NPY" in raw:
        mult = np.asarray(raw["INT8_MULTIPLIERS_NPY"], np.float32)
        arrays["reorder_db"] = np.asarray(raw["INT8_DATASET_NPY"], np.int8)
        arrays["reorder_inv_mult"] = 1.0 / mult
        norms = raw.get("INT8_NORMS_NPY")
        if norms is None or len(norms) == 0:
            deq = arrays["reorder_db"].astype(np.float32) / mult[None, :]
            norms = np.sum(deq * deq, axis=1)
        arrays["reorder_sq_norms"] = np.asarray(norms, np.float32)
    elif rc.quantize == cfg.BFLOAT16 and "BF16_DATASET_NPY" in raw:
        bits = np.asarray(raw["BF16_DATASET_NPY"]).view(np.uint16)
        arrays["reorder_db"] = bits
        f32 = _bf16_bits_to_f32(bits)
        arrays["reorder_sq_norms"] = np.sum(f32 * f32, axis=1)
    elif "DATASET_NPY" in raw:
        if rc.quantize != cfg.FLOAT32:
            config = dataclasses.replace(config, reordering=(
                dataclasses.replace(rc, quantize=cfg.FLOAT32)))
        arrays["reorder_db"] = np.asarray(raw["DATASET_NPY"], np.float32)
    else:
        raise ValueError(
            "exact_reordering configured but no reordering dataset asset "
            "found in the manifest")
    return config


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _np(t) -> np.ndarray:
    """A host numpy copy of a tensor (bfloat16 as its int16 bits) or an
    array."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.detach().cpu().numpy()
    return np.asarray(t)


def save_reference_assets(searcher, artifacts_dir: str,
                          lossy_reorder_downgrade: bool = False):
    """Write a brute-force or tree-AH searcher as a reference-format
    artifact directory (ScannInterface::Serialize role), with the JAX
    package's files and bytes.

    lossy_reorder_downgrade: residual-int8 reorder rows (a layout the
    reference format lacks) are re-quantized to the reference's absolute
    int8 FixedPoint rows instead of raising (coarser rescore steps)."""
    os.makedirs(artifacts_dir, exist_ok=True)
    tname = type(searcher).__name__
    if tname == "TreeAHSearcher":
        assets = _save_tree_ah(searcher, artifacts_dir,
                               lossy_reorder_downgrade)
    elif tname == "BruteForceSearcher":
        assets = _save_brute_force(searcher, artifacts_dir,
                                   lossy_reorder_downgrade)
    else:
        raise ValueError(
            f"{tname} has no reference-format equivalent (tree-SQ/tree-BF "
            "layouts are TPU-native; serialize with save_searcher instead)")
    with open(os.path.join(artifacts_dir, "scann_config.pb"), "wb") as f:
        f.write(encode_scann_config(searcher.config))
    with open(os.path.join(artifacts_dir, "scann_assets.pbtxt"), "w") as f:
        f.write(emit_assets_pbtxt(assets))
    if searcher.docids is not None:
        with open(os.path.join(artifacts_dir, "scann_docids.pkl"),
                  "wb") as f:
            pickle.dump(list(searcher.docids), f)


def _asset_writer(artifacts_dir):
    """(put_npy, put_pb, assets): writers that record each file in the
    manifest list."""
    assets = []

    def put_npy(name, type_name, arr):
        np.save(os.path.join(artifacts_dir, name), arr)
        assets.append((type_name, name))

    def put_pb(name, type_name, data):
        with open(os.path.join(artifacts_dir, name), "wb") as f:
            f.write(data)
        assets.append((type_name, name))

    return put_npy, put_pb, assets


def _save_tree_ah(searcher, artifacts_dir,
                  lossy_reorder_downgrade: bool = False):
    put_npy, put_pb, assets = _asset_writer(artifacts_dir)
    codebook = _np(searcher.model.codebook).astype(np.float32)
    put_pb("ah_codebook.pb", "AH_CENTERS", encode_codebook(codebook))

    tok = np.asarray(searcher.datapoint_to_token, np.int32)
    n = searcher.n_points
    host = searcher._host
    live = host["dpid"] >= 0
    dpid, leaf = host["dpid"][live], host["leaf"][live]
    codes = host["codes"][live]

    codes_by_dp = np.zeros((n, codes.shape[1]), np.uint8)
    if searcher.partitioner is not None:
        centers = _np(searcher.partitioner.centers).astype(np.float32)
        put_pb("serialized_partitioner.pb", "PARTITIONER",
               encode_partitioner(centers))
        if tok.shape[1] == 2:
            # SOAR: interleaved (2n,) slot tokens, even = primary, odd =
            # secondary (-1 where both are one leaf); the codes pair with
            # the slots by position (even rows in hashed_dataset.npy, odd
            # in hashed_dataset_soar.npy).  Primary first keeps a
            # re-imported slot layout identical to the original's.
            interleaved = np.empty((2 * n,), np.int32)
            interleaved[0::2] = tok[:, 0]
            interleaved[1::2] = np.where(tok[:, 1] == tok[:, 0], -1,
                                         tok[:, 1])
            put_npy("datapoint_to_token.npy", "TOKENIZATION_NPY",
                    interleaved)
            codes_secondary = np.zeros((n, codes.shape[1]), np.uint8)
            is_primary = leaf == tok[dpid, 0]
            codes_by_dp[dpid[is_primary]] = codes[is_primary]
            codes_secondary[dpid[~is_primary]] = codes[~is_primary]
            put_npy("hashed_dataset.npy", "AH_DATASET_NPY", codes_by_dp)
            put_npy("hashed_dataset_soar.npy", "AH_DATASET_SOAR_NPY",
                    codes_secondary)
            _save_reorder(searcher, put_npy, lossy_reorder_downgrade)
            return assets
        put_npy("datapoint_to_token.npy", "TOKENIZATION_NPY",
                tok[:, 0].astype(np.int32))
    codes_by_dp[dpid] = codes
    put_npy("hashed_dataset.npy", "AH_DATASET_NPY", codes_by_dp)
    _save_reorder(searcher, put_npy, lossy_reorder_downgrade)
    return assets


def _save_brute_force(searcher, artifacts_dir,
                      lossy_reorder_downgrade: bool = False):
    put_npy, _, assets = _asset_writer(artifacts_dir)
    db = _np(searcher._db)
    if searcher.quantize_mode == cfg.INT8:
        put_npy("int8_dataset.npy", "INT8_DATASET_NPY",
                db.astype(np.int8))
        put_npy("int8_multipliers.npy", "INT8_MULTIPLIERS_NPY",
                1.0 / _np(searcher._inv_mult).astype(np.float32))
        put_npy("dp_norms.npy", "INT8_NORMS_NPY",
                _np(searcher._sq_norms).astype(np.float32))
    elif searcher.quantize_mode == cfg.BFLOAT16:
        put_npy("bfloat16_dataset.npy", "BF16_DATASET_NPY",
                db.astype(np.int16))
    else:
        put_npy("dataset.npy", "DATASET_NPY", db.astype(np.float32))
    _save_reorder(searcher, put_npy, lossy_reorder_downgrade)
    return assets


def _save_reorder(searcher, put_npy, lossy_downgrade: bool = False):
    rh = searcher.reorder_helper
    if rh is None:
        return
    if rh._leaf is not None:
        if not lossy_downgrade:
            raise ValueError(
                "residual int8 reordering is a TPU-native layout with no "
                "reference-format equivalent; pass "
                "lossy_reorder_downgrade=True to re-quantize to the "
                "reference's absolute int8 FixedPoint format (coarser "
                "steps), rebuild with reorder(..., residual=False), or "
                "use save_searcher")
        # Reconstruct the residual rows (q8 * row_scale + c_leaf) and
        # re-quantize them as absolute int8 with per-dimension multipliers,
        # the reference's FixedPointFloat layout.  The per-row residual
        # scales are finer than per-dimension steps, so the exported
        # rescore is coarser than the live one.
        q8 = _np(rh._db).astype(np.float32)
        scale = _np(rh._row_scale).astype(np.float32)
        c_rows = _np(rh._centers).astype(np.float32)[
            _np(rh._leaf).astype(np.int64)]
        x_hat = q8 * scale.reshape(-1)[:, None] + c_rows
        mult = 127.0 / np.maximum(np.abs(x_hat).max(axis=0), 1e-20)
        data = np.clip(np.round(x_hat * mult[None, :]), -127, 127
                       ).astype(np.int8)
        deq = data.astype(np.float32) / mult[None, :]
        put_npy("int8_dataset.npy", "INT8_DATASET_NPY", data)
        put_npy("int8_multipliers.npy", "INT8_MULTIPLIERS_NPY",
                mult.astype(np.float32))
        put_npy("dp_norms.npy", "INT8_NORMS_NPY",
                np.sum(deq * deq, axis=-1).astype(np.float32))
        return
    if rh.config.quantize == cfg.INT8:
        put_npy("int8_dataset.npy", "INT8_DATASET_NPY",
                _np(rh._db).astype(np.int8))
        put_npy("int8_multipliers.npy", "INT8_MULTIPLIERS_NPY",
                1.0 / _np(rh._inv_mult).astype(np.float32))
        put_npy("dp_norms.npy", "INT8_NORMS_NPY",
                _np(rh._sq_norms).astype(np.float32))
    elif rh.config.quantize == cfg.BFLOAT16:
        put_npy("bfloat16_dataset.npy", "BF16_DATASET_NPY",
                _np(rh._db).astype(np.int16))
    else:
        put_npy("dataset.npy", "DATASET_NPY",
                _np(rh._db).astype(np.float32))
