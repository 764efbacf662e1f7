"""Minimal GGUF writer (f32 tensors, or f16 matmul weights) — the inverse of
nn/prostt5.read_gguf, and the port's copy of `foldseek_tpu`'s writer: the
same param tree gives the same bytes.

Two uses:
  * validating the GGUF load path end-to-end without the released ProstT5
    weights (the real artifact is `weights/prostt5-f16.gguf` from the
    reference's `databases ProstT5` download, src/FoldseekBase.cpp:446-551 /
    data/structdatabases.sh);
  * writing a release-shaped model made on the device: a tensor of the tree
    may be a torch tensor (on any device) as well as a numpy array, and is
    cast to its stored dtype where it lies before it is copied to the host.
"""
from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np
import torch

from .prostt5 import GGML_F16, GGUF_MAGIC, ProstT5Config

_T_U32, _T_F32, _T_STR, _T_ARR = 4, 6, 8, 9
GGML_F32 = 0
ALIGNMENT = 32


def _w_str(f, s: str):
    b = s.encode("utf-8")
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _w_value(f, v):
    if isinstance(v, str):
        f.write(struct.pack("<I", _T_STR))
        _w_str(f, v)
    elif isinstance(v, bool):
        raise TypeError("bool kv unsupported")
    elif isinstance(v, int):
        f.write(struct.pack("<I", _T_U32))
        f.write(struct.pack("<I", v))
    elif isinstance(v, float):
        f.write(struct.pack("<I", _T_F32))
        f.write(struct.pack("<f", v))
    elif isinstance(v, list):
        f.write(struct.pack("<I", _T_ARR))
        f.write(struct.pack("<I", _T_STR))  # string arrays only (vocab)
        f.write(struct.pack("<Q", len(v)))
        for s in v:
            _w_str(f, s)
    else:
        raise TypeError(type(v))


def _padded(n: int) -> int:
    return (n + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT


def write_gguf(path: str, meta: Dict, tensors: Dict[str, object],
               f16_weights: bool = False):
    """Write tensors; dims are stored innermost-first per the spec.

    f16_weights mirrors the released ProstT5 GGUF's dtype layout
    (prostt5_manifest.json: f16 matmul weights, f32 norms/biases) — every
    tensor with ndim >= 2 is stored GGML_F16, 1-D tensors stay GGML_F32."""
    def _dtype(arr):
        return (GGML_F16 if f16_weights and arr.ndim >= 2 else GGML_F32)

    def _bytes(arr):
        f16 = _dtype(arr) == GGML_F16
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().to(torch.float16 if f16 else torch.float32)
            return arr.contiguous().cpu().numpy().tobytes()
        dt = np.float16 if f16 else np.float32
        return np.ascontiguousarray(arr.astype(dt)).tobytes()

    with open(path, "wb") as f:
        f.write(struct.pack("<II", GGUF_MAGIC, 3))
        f.write(struct.pack("<QQ", len(tensors), len(meta)))
        for k, v in meta.items():
            _w_str(f, k)
            _w_value(f, v)
        offset = 0
        for name, arr in tensors.items():
            _w_str(f, name)
            dims = tuple(reversed(arr.shape))
            f.write(struct.pack("<I", len(dims)))
            f.write(struct.pack(f"<{len(dims)}Q", *dims))
            f.write(struct.pack("<I", _dtype(arr)))
            f.write(struct.pack("<Q", offset))
            itemsize = 2 if _dtype(arr) == GGML_F16 else 4
            offset += _padded(int(np.prod(arr.shape)) * itemsize)
        base = f.tell()
        f.write(b"\0" * (_padded(base) - base))
        for arr in tensors.values():
            b = _bytes(arr)
            f.write(b)
            f.write(b"\0" * (_padded(len(b)) - len(b)))


def default_vocab(vocab_size: int) -> List[str]:
    """Token list with the entries the tokenizer needs, padded to size."""
    toks = ["<pad>", "</s>", "▁X", "<AA2fold>", "<fold2AA>"]
    toks += ["▁" + c for c in "ACDEFGHIKLMNPQRSTVWY"]
    toks += [f"<extra_{i}>" for i in range(vocab_size - len(toks))]
    return toks[:vocab_size]


def write_prostt5_gguf(path: str, cfg: ProstT5Config, params,
                       vocab: List[str] = None, f16_weights: bool = False):
    """Serialize our param tree into the llama.cpp T5ENCODER GGUF layout
    that load_params_gguf consumes (matmul weights stored [out, in])."""
    arch = "t5encoder"
    meta = {
        "general.architecture": arch,
        "general.alignment": ALIGNMENT,
        f"{arch}.block_count": cfg.num_layers,
        f"{arch}.embedding_length": cfg.d_model,
        f"{arch}.attention.key_length": cfg.d_kv,
        f"{arch}.attention.head_count": cfg.num_heads,
        f"{arch}.feed_forward_length": cfg.d_ff,
        f"{arch}.attention.relative_buckets_count": cfg.rel_buckets,
        "tokenizer.ggml.tokens": vocab or default_vocab(cfg.vocab_size),
    }
    tensors = {
        "token_embd.weight": params["embed"],
        "enc.output_norm.weight": params["final_norm"],
    }
    for i, layer in enumerate(params["layers"]):
        prefix = f"enc.blk.{i}."
        tensors[prefix + "attn_norm.weight"] = layer["attn_norm"]
        tensors[prefix + "attn_q.weight"] = layer["wq"].T
        tensors[prefix + "attn_k.weight"] = layer["wk"].T
        tensors[prefix + "attn_v.weight"] = layer["wv"].T
        tensors[prefix + "attn_o.weight"] = layer["wo"].T
        tensors[prefix + "ffn_norm.weight"] = layer["ffn_norm"]
        tensors[prefix + "ffn_up.weight"] = layer["ffn_up"].T
        tensors[prefix + "ffn_down.weight"] = layer["ffn_down"].T
        if i == 0:
            tensors[prefix + "attn_rel_b.weight"] = params["rel_bias"]
    # the release layout names the CNN head "classifier.%d"
    # (lib/prostt5 llama.cpp t5encoder tensor table :1520)
    tensors["classifier.0.weight"] = params["conv0_w"]
    tensors["classifier.0.bias"] = params["conv0_b"]
    tensors["classifier.3.weight"] = params["conv3_w"]
    tensors["classifier.3.bias"] = params["conv3_b"]
    write_gguf(path, meta, tensors, f16_weights=f16_weights)
