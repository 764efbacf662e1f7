"""ProstT5: 3Di structural alphabet prediction from amino-acid sequence.

The port's copy of `foldseek_tpu`'s ProstT5 (reference: the GGML/llama.cpp
runner, src/strucclustutils/ProstT5.cpp, lib/prostt5/src/llama.cpp
LLM_ARCH_T5ENCODER graph :9383-9417 tensors, :11230-11295 CNN head):

  tokens  = [<AA2fold>] + [▁A..▁Y per residue] + [</s>]
  x       = T5 encoder (RMSNorm pre-norm, relative-position-bucket attention
            without query scaling, ReLU FFN)
  h       = x[1:-1] padded by one zero row            (llama.cpp:11240-11256)
  logits  = conv1d_k7(h, 1024->32) + b -> relu -> conv1d_k7(32->20) + b
  3Di     = argmax over the 20 states per residue     (ProstT5.cpp:34-65)

The encoder is plain PyTorch (`ProstT5Encoder`) with the JAX package's
numerics: the residual stream stays in the compute dtype (bfloat16 by
default) and RMSNorm computes in float32 and casts back; the matmul weights
are cast to the compute dtype once, when they are loaded; the attention
scores and the context take float32 products of the bfloat16 operands; the
relative bias, the mask and the softmax are float32; the CNN head is float32
and written as an unfold plus a matmul, so that no convolution runs in TF32.
The float32 products rely on `torch.backends.cuda.matmul.allow_tf32` being
False, its default.

Weights load from the GGUF file the reference distributes (weights/ in the
foldseek release; `foldseek databases ProstT5`), f32/f16 tensors only.
"""
from __future__ import annotations

import math
import struct
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.log import logger, record_count, record_stage

THREE_DI = "ACDEFGHIKLMNPQRSTVWY"  # number_to_char (ProstT5.cpp:8-32)


@dataclass
class ProstT5Config:
    vocab_size: int = 150
    d_model: int = 1024
    d_kv: int = 128
    num_heads: int = 32
    d_ff: int = 16384
    num_layers: int = 24
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    conv_hidden: int = 32
    n_states: int = 20

    @staticmethod
    def tiny() -> "ProstT5Config":
        """Small config for quick checks."""
        return ProstT5Config(vocab_size=64, d_model=64, d_kv=16, num_heads=4,
                             d_ff=128, num_layers=2)


# ---------------------------------------------------------------------------
# GGUF reader (minimal: header + f32/f16 tensors)

GGUF_MAGIC = 0x46554747
_GGUF_TYPES = {0: "B", 1: "b", 2: "H", 3: "h", 4: "I", 5: "i", 6: "f",
               7: "?", 10: "Q", 11: "q", 12: "d"}
GGML_F32, GGML_F16 = 0, 1


def _read_gguf_value(f, vtype):
    if vtype == 8:  # string
        n = struct.unpack("<Q", f.read(8))[0]
        return f.read(n).decode("utf-8", errors="replace")
    if vtype == 9:  # array
        etype = struct.unpack("<I", f.read(4))[0]
        n = struct.unpack("<Q", f.read(8))[0]
        return [_read_gguf_value(f, etype) for _ in range(n)]
    fmt = _GGUF_TYPES[vtype]
    return struct.unpack("<" + fmt, f.read(struct.calcsize(fmt)))[0]


def read_gguf(path: str):
    """Returns (metadata dict, {tensor name: np.ndarray}). Tensors are
    returned with GGUF's dims reversed into row-major numpy order."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<II", f.read(8))
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
        meta = {}
        for _ in range(n_kv):
            klen = struct.unpack("<Q", f.read(8))[0]
            key = f.read(klen).decode()
            vtype = struct.unpack("<I", f.read(4))[0]
            meta[key] = _read_gguf_value(f, vtype)
        infos = []
        for _ in range(n_tensors):
            nlen = struct.unpack("<Q", f.read(8))[0]
            name = f.read(nlen).decode()
            ndim = struct.unpack("<I", f.read(4))[0]
            dims = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
            dtype = struct.unpack("<I", f.read(4))[0]
            offset = struct.unpack("<Q", f.read(8))[0]
            infos.append((name, dims, dtype, offset))
        alignment = meta.get("general.alignment", 32)
        base = f.tell()
        base = (base + alignment - 1) // alignment * alignment
        tensors = {}
        for name, dims, dtype, offset in infos:
            count = int(np.prod(dims))
            f.seek(base + offset)
            # np.fromfile: writable arrays, which torch.from_numpy takes
            if dtype == GGML_F32:
                arr = np.fromfile(f, dtype=np.float32, count=count)
            elif dtype == GGML_F16:
                arr = np.fromfile(f, dtype=np.float16, count=count).astype(np.float32)
            else:
                raise ValueError(
                    f"{path}: tensor {name} has unsupported ggml dtype {dtype} "
                    "(quantized models are not supported; use an f16/f32 GGUF)")
            # GGUF dims are innermost-first; numpy wants outermost-first
            tensors[name] = arr.reshape(tuple(reversed(dims)))
        return meta, tensors


# ---------------------------------------------------------------------------
# parameters (a tree of numpy arrays, the JAX package's layout)

def load_params_gguf(path: str):
    """Map GGUF tensor names (llama.cpp T5ENCODER layout) to our param tree,
    plus the token vocabulary."""
    meta, t = read_gguf(path)
    return map_gguf_params(meta, t)


def map_gguf_params(meta, t):
    """The name->param-tree mapping, split from file reading so that the
    release manifest (tests/golden/prostt5_manifest.json) can drive it
    without a real 11 GB GGUF."""
    arch = meta.get("general.architecture", "?")
    n_layers = meta.get(f"{arch}.block_count")
    cfg = ProstT5Config(
        vocab_size=t["token_embd.weight"].shape[0],
        d_model=meta.get(f"{arch}.embedding_length", 1024),
        d_kv=meta.get(f"{arch}.attention.key_length", 128),
        num_heads=meta.get(f"{arch}.attention.head_count", 32),
        d_ff=meta.get(f"{arch}.feed_forward_length", 16384),
        num_layers=n_layers if n_layers else 24,
        rel_buckets=meta.get(f"{arch}.attention.relative_buckets_count", 32),
    )
    params = {"embed": t["token_embd.weight"],
              "final_norm": t["enc.output_norm.weight"]}
    layers = []
    rel_bias = None
    for i in range(cfg.num_layers):
        prefix = f"enc.blk.{i}."
        layer = {
            "attn_norm": t[prefix + "attn_norm.weight"],
            # llama.cpp stores matmul weights as [out, in]; transpose to
            # x @ W convention
            "wq": t[prefix + "attn_q.weight"].T,
            "wk": t[prefix + "attn_k.weight"].T,
            "wv": t[prefix + "attn_v.weight"].T,
            "wo": t[prefix + "attn_o.weight"].T,
            "ffn_norm": t[prefix + "ffn_norm.weight"],
            "ffn_up": t[prefix + "ffn_up.weight"].T,
            "ffn_down": t[prefix + "ffn_down.weight"].T,
        }
        # flan-style gated FFN when present (the graph builder switches on
        # it: ffn_gate_enc ? GELU/PAR : RELU/SEQ, lib/prostt5 llama.cpp
        # :16557-16565); plain ProstT5 (T5-3B lineage) has no gate
        gate = t.get(prefix + "ffn_gate.weight")
        if gate is not None:
            layer["ffn_gate"] = gate.T
        rb = t.get(prefix + "attn_rel_b.weight")
        if rb is not None:
            rel_bias = rb
        layers.append(layer)
    if rel_bias is None:
        raise ValueError("missing relative attention bias tensor")
    # gguf dims {n_head, n_buckets} reversed -> [n_buckets, n_head]
    params["rel_bias"] = rel_bias
    params["layers"] = layers

    def cnn(which, idx):
        # the released GGUF names the CNN head "classifier.%d" (llama.cpp
        # LLM_TENSOR_CONV1D table for t5encoder, :1520); accept the older
        # synthetic "conv1d.%d" spelling too
        for stem in (f"classifier.{idx}.{which}", f"conv1d.{idx}.{which}"):
            if stem in t:
                return t[stem]
        raise KeyError(f"classifier.{idx}.{which} missing from GGUF")
    params["conv0_w"] = cnn("weight", 0)   # [32, 1024, 1, 7] after reversal
    params["conv0_b"] = cnn("bias", 0)
    params["conv3_w"] = cnn("weight", 3)   # [20, 32, 1, 7]
    params["conv3_b"] = cnn("bias", 3)

    vocab = meta.get("tokenizer.ggml.tokens", [])
    token_id = {tok: i for i, tok in enumerate(vocab)}
    return cfg, params, token_id


def init_random_params(cfg: ProstT5Config, seed: int = 0):
    """Random params with the real tree structure; numpy's RandomState, so
    that `foldseek_tpu`'s function of the same name gives the same arrays."""
    rng = np.random.RandomState(seed)

    def r(*shape):
        return (rng.randn(*shape) * 0.02).astype(np.float32)

    params = {
        "embed": r(cfg.vocab_size, cfg.d_model),
        "final_norm": np.ones(cfg.d_model, np.float32),
        "rel_bias": r(cfg.rel_buckets, cfg.num_heads),
        "layers": [
            {
                "attn_norm": np.ones(cfg.d_model, np.float32),
                "wq": r(cfg.d_model, cfg.num_heads * cfg.d_kv),
                "wk": r(cfg.d_model, cfg.num_heads * cfg.d_kv),
                "wv": r(cfg.d_model, cfg.num_heads * cfg.d_kv),
                "wo": r(cfg.num_heads * cfg.d_kv, cfg.d_model),
                "ffn_norm": np.ones(cfg.d_model, np.float32),
                "ffn_up": r(cfg.d_model, cfg.d_ff),
                "ffn_down": r(cfg.d_ff, cfg.d_model),
            } for _ in range(cfg.num_layers)
        ],
        "conv0_w": r(cfg.conv_hidden, cfg.d_model, 1, 7),
        "conv0_b": r(cfg.conv_hidden),
        "conv3_w": r(cfg.n_states, cfg.conv_hidden, 1, 7),
        "conv3_b": r(cfg.n_states),
    }
    return params


# ---------------------------------------------------------------------------
# forward

def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5 bidirectional bucketing (HF T5Attention._relative_position_bucket)
    of an integer tensor, in float32 as the JAX package computes it."""
    num_buckets //= 2
    ret = (rel_pos > 0).to(torch.int32) * num_buckets
    n = rel_pos.abs().to(torch.int32)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def bucket_table(T: int, cfg: ProstT5Config, device) -> torch.Tensor:
    """[T, T] bucket of key position minus query position, computed on
    `device`: the buckets of the 2T-1 distances, gathered."""
    rel = torch.arange(-(T - 1), T, device=device, dtype=torch.int32)
    by_distance = relative_position_bucket(rel, cfg.rel_buckets,
                                           cfg.rel_max_distance)
    pos = torch.arange(T, device=device)
    return by_distance[pos[None, :] - pos[:, None] + (T - 1)]


_MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "ffn_up", "ffn_down", "ffn_gate")


def params_from_numpy(cfg: ProstT5Config, params, device,
                      dtype: torch.dtype = torch.bfloat16) -> dict:
    """The JAX package's param tree (numpy arrays) on `device`: the matmul
    weights in `dtype`, the compute dtype (the JAX package casts each float32
    weight to it inside every matmul; casting once gives the same values),
    everything else float32. Each array travels in its own layout and is
    cast on the device. Raises when a layer's shapes are not those of
    `cfg` (a GGUF whose metadata disagrees with its tensors)."""
    device = torch.device(device)
    inner = cfg.num_heads * cfg.d_kv
    for i, layer in enumerate(params["layers"]):
        if (np.shape(layer["wq"]) != (cfg.d_model, inner)
                or np.shape(layer["ffn_up"]) != (cfg.d_model, cfg.d_ff)):
            raise ValueError(f"ProstT5 layer {i}: weights of shape "
                             f"{np.shape(layer['wq'])} and "
                             f"{np.shape(layer['ffn_up'])} do not fit d_model "
                             f"{cfg.d_model}, {cfg.num_heads} heads of "
                             f"{cfg.d_kv}, d_ff {cfg.d_ff}")

    def put(a, dt):
        return torch.from_numpy(np.asarray(a)).to(device).to(dt)

    out = {k: put(params[k], torch.float32)
           for k in ("embed", "final_norm", "rel_bias", "conv0_w", "conv0_b",
                     "conv3_w", "conv3_b")}
    out["layers"] = [
        {k: put(v, dtype if k in _MATMUL_WEIGHTS else torch.float32)
         for k, v in layer.items()} for layer in params["layers"]]
    return out


class _Layer(nn.Module):
    def __init__(self, tensors: dict):
        super().__init__()
        for k, v in tensors.items():
            self.register_buffer(k, v, persistent=False)
        self.gated = "ffn_gate" in tensors


class ProstT5Encoder(nn.Module):
    """The T5 encoder and CNN head over the tensors of `params_from_numpy`;
    its compute dtype is that of the matmul weights."""

    def __init__(self, cfg: ProstT5Config, tensors: dict):
        super().__init__()
        self.cfg = cfg
        for k, v in tensors.items():
            if k != "layers":
                self.register_buffer(k, v, persistent=False)
        self.layers = nn.ModuleList(_Layer(t) for t in tensors["layers"])
        self.compute_dtype = tensors["layers"][0]["wq"].dtype

    def _rms(self, x, w):
        var = x.float().square().mean(-1, keepdim=True)
        out = x.float() * torch.rsqrt(var + self.cfg.layer_norm_eps)
        return (out * w).to(self.compute_dtype)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, mask: torch.Tensor,
                head: bool = True) -> torch.Tensor:
        """tokens: int [B, T]; mask: bool [B, T]. Returns float32 3Di logits
        [B, T-1, 20] (logits[i] scores residue i; positions past L-1 are
        invalid), or with head=False the final hidden states [B, T, d]."""
        cfg, cdt = self.cfg, self.compute_dtype
        B, T = tokens.shape
        H, dk = cfg.num_heads, cfg.d_kv
        x = self.embed[tokens.long()].to(cdt)
        buckets = bucket_table(T, cfg, tokens.device)
        bias = self.rel_bias[buckets].permute(2, 0, 1).contiguous()[None]
        neg = torch.finfo(torch.float32).min
        attn_mask = torch.where(mask[:, None, None, :], 0.0, neg).to(
            torch.float32)                                        # [B,1,1,T]
        for layer in self.layers:
            h = self._rms(x, layer.attn_norm)
            q = (h @ layer.wq).view(B, T, H, dk).transpose(1, 2)
            k = (h @ layer.wk).view(B, T, H, dk).transpose(1, 2)
            v = (h @ layer.wv).view(B, T, H, dk).transpose(1, 2)
            # T5: no 1/sqrt(d_kv) scaling; float32 products of the
            # compute-dtype operands (preferred_element_type=float32)
            scores = q.float() @ k.float().transpose(-1, -2)
            del q, k
            scores += bias
            scores += attn_mask
            probs = torch.softmax(scores, dim=-1).to(cdt)
            del scores
            ctx = probs.float() @ v.float()
            del probs, v
            ctx = ctx.transpose(1, 2).reshape(B, T, H * dk).to(cdt)
            x = x + (ctx @ layer.wo).to(cdt)
            del ctx

            h = self._rms(x, layer.ffn_norm)
            if layer.gated:
                # flan-style gated GELU (llm_build_ffn GELU/PAR branch)
                up = F.gelu(h @ layer.ffn_gate) * (h @ layer.ffn_up)
            else:
                up = torch.relu(h @ layer.ffn_up)
            x = x + (up @ layer.ffn_down).to(cdt)
            del up, h
        x = self._rms(x, self.final_norm).float()
        if not head:
            return x

        # CNN head (llama.cpp:11230-11295): rows 1..T-2 then one zero row;
        # each conv (kernel 7, padding 3) is its windows times the flattened
        # kernel, a float32 matmul
        h = F.pad(x[:, 1:-1, :], (0, 0, 0, 1))
        h = torch.relu(_conv7(h, self.conv0_w) + self.conv0_b)
        return _conv7(h, self.conv3_w) + self.conv3_b


def _conv7(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv1d over the tokens of h [B, T, C] with a GGUF kernel
    [O, C, 1, 7] and padding 3: [B, T, O]."""
    B, T, C = h.shape
    windows = F.pad(h, (0, 0, 3, 3)).unfold(1, 7, 1)              # [B,T,C,7]
    return windows.reshape(B * T, C * 7).matmul(
        w[:, :, 0, :].reshape(w.shape[0], C * 7).t()).view(B, T, -1)


# ---------------------------------------------------------------------------
# predictor


class ProstT5:
    """Batched 3Di predictor with length bucketing: sequences sorted by
    length, batches of `batch_size`, each padded to the next power of two of
    at least 16 tokens. `split_length` is kept as the JAX package keeps it;
    `predict` does not split long sequences into windows."""

    def __init__(self, model_file: Optional[str] = None,
                 cfg: Optional[ProstT5Config] = None,
                 params=None, token_id: Optional[Dict[str, int]] = None,
                 split_length: int = 1024, device="cuda",
                 dtype: torch.dtype = torch.bfloat16):
        if model_file is not None:
            cfg, params, token_id = load_params_gguf(model_file)
            logger.info("ProstT5: loaded %s (%d layers, d_model %d, vocab %d)",
                        model_file, cfg.num_layers, cfg.d_model, cfg.vocab_size)
        if cfg is None or params is None:
            raise ValueError("ProstT5 needs a model file or cfg and params")
        self.cfg = cfg
        self.device = torch.device(device)
        self.encoder = ProstT5Encoder(
            cfg, params_from_numpy(cfg, params, self.device, dtype))
        self.token_id = token_id or {}
        self.split_length = split_length

    def _tok(self, name, default=0):
        return self.token_id.get(name, default)

    def tokenize(self, seq: str, pad_to: int) -> np.ndarray:
        prefix = self._tok("<AA2fold>", 3)
        eos = self._tok("</s>", 1)
        unk = self._tok("▁X", 2)
        toks = [prefix]
        for c in seq.upper():
            toks.append(self._tok("▁" + c, unk))
        toks.append(eos)
        out = np.zeros(pad_to, dtype=np.int32)
        out[:len(toks)] = toks
        return out

    def batch(self, seqs: List[str]):
        """(tokens, mask) of one batch on the model's device, padded to the
        next power of two of at least 16 tokens."""
        max_t = max(len(s) for s in seqs) + 2
        pad_to = max(16, 1 << (max_t - 1).bit_length())
        toks = np.stack([self.tokenize(s, pad_to) for s in seqs])
        mask = np.zeros_like(toks, dtype=bool)
        for row, s in enumerate(seqs):
            mask[row, :len(s) + 2] = True
        return (torch.from_numpy(toks).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def predict(self, seqs: List[str], batch_size: int = 8) -> List[str]:
        """3Di strings for a list of AA sequences. Each batch records, under
        its pad length T, its seconds (stage `prostt5_T<T>`), its rows and
        real tokens (counts `prostt5_T<T>_rows`, `_tokens`) and on a card the
        peak device memory so far (`_peak_bytes`)."""
        out = [None] * len(seqs)
        order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
        for start in range(0, len(order), batch_size):
            idx = order[start:start + batch_size]
            t0 = time.perf_counter()
            tokens, mask = self.batch([seqs[i] for i in idx])
            logits = self.encoder(tokens, mask)
            states = logits[:, :, :self.cfg.n_states].cpu().numpy().argmax(-1)
            label = f"prostt5_T{tokens.shape[1]}"
            record_stage(label, time.perf_counter() - t0)
            record_count(label + "_rows", len(idx))
            record_count(label + "_tokens", sum(len(seqs[i]) + 2 for i in idx))
            if self.device.type == "cuda":
                record_count(label + "_peak_bytes",
                             torch.cuda.max_memory_allocated(self.device))
            for row, i in enumerate(idx):
                out[i] = "".join(THREE_DI[s] for s in states[row, :len(seqs[i])])
        return out
