"""The port's ProstT5 (nn/prostt5.py, nn/gguf_writer.py, createdb
--prostt5-model) on the CPU against foldseek_tpu's on the same seeded numpy
inputs, and the search of a DB that holds no C-alpha coordinates.

Tolerances: float32 in both packages, hidden states and logits within 1e-5;
bfloat16 in both, logits within 1e-2 and hidden states within four bfloat16
units in the last place of JAX's largest |value| (the final RMSNorm gives
them unit RMS and maxima near 4, where one unit is 2^-5: 1e-2 is below it).
In bfloat16 two correct programs can pick different 3Di letters where the top
two logits lie closer than their difference, so letters are held by the
margin rule: equal at every residue whose top-two margin in JAX's logits
exceeds twice the measured max |Δlogit|; the residues inside that band are
reported, not failed on. The release-shaped model is held by the margin rule
alone.

The two packages meet only through numpy arrays, files and DB directories.
The port's k-mer prefilter must not fork this process (it holds a live JAX
client), hence FOLDSEEK_TPU_FORK=0."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldseek_tpu.cli import main as jmain
from foldseek_tpu.db.storage import load_db
from foldseek_tpu.ingest.createdb import create_db as jcreate_db
from foldseek_tpu.nn import gguf_writer as jw
from foldseek_tpu.nn import prostt5 as J
from foldseek_tpu_torch.cli import main as tmain
from foldseek_tpu_torch.nn import gguf_writer as tw
from foldseek_tpu_torch.nn import prostt5 as P

CPU = torch.device("cpu")
QUIET = ["-v", "1"]
SMALL = P.ProstT5Config(vocab_size=150, d_model=256, d_kv=32, num_heads=8,
                        d_ff=1024, num_layers=4)
RELEASE_2 = P.ProstT5Config(num_layers=2)
SEQS = ["MKTAYIAKQRQISFVKSHFSRQ", "ACDEFGHIKLMNPQRSTVWY" * 6, "WWX",
        "MSTNPKPQRKTKRNTNRRPQDVKFPGGGQIVGGVYLLPRRGPRLGVRATRKTSERSQPRGRRQPIPK",
        "GSHMLEDPVDAFQ" * 3, "MAAB", "PEPTIDE" * 11, "MKV" * 40, "LLLLVVVVAAAG"]


@pytest.fixture(autouse=True)
def _no_fork(monkeypatch):
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")


def _jcfg(cfg):
    return J.ProstT5Config(**cfg.__dict__)


def _params(cfg, seed, gated=False):
    params = P.init_random_params(cfg, seed=seed)
    if gated:
        rng = np.random.RandomState(seed + 100)
        for layer in params["layers"]:
            layer["ffn_gate"] = (rng.randn(cfg.d_model, cfg.d_ff)
                                 * 0.02).astype(np.float32)
    return params


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    B, T = 4, 128
    tokens = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = np.zeros((B, T), bool)
    for b, n in enumerate((128, 70, 20, 101)):
        mask[b, :n] = True
    tokens[~mask] = 0
    return tokens, mask


def _valid_residues(mask):
    """[B, T-1] residues a logit row scores: the first L of each row."""
    valid = np.zeros((mask.shape[0], mask.shape[1] - 1), bool)
    for b, n in enumerate(mask.sum(1)):
        valid[b, :n - 2] = True
    return valid


def _margin_rule(jax_logits, port_logits, valid, what):
    """Max |Δlogit| over the valid residues; letters equal wherever JAX's
    top-two margin exceeds twice it. Returns (max |Δ|, residues in band)."""
    j = np.asarray(jax_logits, np.float32)[..., :20][valid]
    p = np.asarray(port_logits, np.float32)[..., :20][valid]
    d = float(np.abs(j - p).max())
    top2 = np.sort(j, -1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    differ = j.argmax(-1) != p.argmax(-1)
    assert not (differ & (margin > 2 * d)).any(), (what, d)
    print(f"{what}: max |dlogit| {d:.3g}, {int(differ.sum())} of {len(j)} "
          f"letters differ, {int((margin <= 2 * d).sum())} residues inside "
          "the margin band")
    return d, int(differ.sum())


@pytest.mark.parametrize("T", [16, 300, 4096])
def test_bucket_table_matches_jax(T):
    pos = np.arange(T)
    want = np.asarray(J.relative_position_bucket(
        jnp.asarray(pos[None, :] - pos[:, None]), 32, 128))
    got = P.bucket_table(T, P.ProstT5Config(), CPU).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("gated", [False, True], ids=["relu", "gated_gelu"])
@pytest.mark.parametrize("cfg", [P.ProstT5Config.tiny(), SMALL],
                         ids=["tiny", "d256_4layers"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(cfg, gated, dtype):
    params = _params(cfg, 1, gated)
    tokens, mask = _batch(cfg, 2)
    enc = P.ProstT5Encoder(cfg, P.params_from_numpy(
        cfg, params, CPU, getattr(torch, dtype)))
    t_tok, t_mask = torch.from_numpy(tokens), torch.from_numpy(mask)
    hidden = enc(t_tok, t_mask, head=False).numpy()
    logits = enc(t_tok, t_mask).numpy()
    j = dict(params=params, cfg=_jcfg(cfg), tokens=jnp.asarray(tokens),
             mask=jnp.asarray(mask), compute_dtype=getattr(jnp, dtype))
    j_hidden = np.asarray(J.encoder_forward(**j, head=False))
    j_logits = np.asarray(J.encoder_forward(**j))
    assert hidden.shape == j_hidden.shape and logits.shape == j_logits.shape
    valid = _valid_residues(mask)
    if dtype == "float32":
        assert np.abs(hidden - j_hidden)[mask].max() <= 1e-5
        assert np.abs(logits - j_logits)[valid].max() <= 1e-5
        assert np.array_equal(logits[valid].argmax(-1),
                              j_logits[valid].argmax(-1))
    else:
        top = np.abs(j_hidden)[mask].max()
        ulp = np.exp2(np.floor(np.log2(top)) - 7)
        assert np.abs(hidden - j_hidden)[mask].max() <= 4 * ulp
        d, _ = _margin_rule(j_logits, logits, valid, f"{cfg.d_model} {dtype}")
        assert d <= 1e-2


@pytest.mark.parametrize("source", ["numpy", "torch"])
@pytest.mark.parametrize("f16", [False, True], ids=["f32", "f16_weights"])
def test_gguf_writer_matches_jax_bytes(tmp_path, f16, source):
    """The port's writer gives JAX's writer's bytes, from numpy arrays and
    from torch tensors of the same values."""
    cfg = P.ProstT5Config.tiny()
    params = P.init_random_params(cfg, seed=5)
    jw.write_prostt5_gguf(str(tmp_path / "j.gguf"), _jcfg(cfg), params,
                          f16_weights=f16)
    if source == "torch":
        params = P.params_from_numpy(cfg, params, CPU, torch.float32)
    tw.write_prostt5_gguf(str(tmp_path / "p.gguf"), cfg, params,
                          f16_weights=f16)
    assert (tmp_path / "p.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()


@pytest.mark.parametrize("f16", [False, True], ids=["f32", "f16_weights"])
def test_gguf_reader_matches_jax(tmp_path, f16):
    cfg = P.ProstT5Config.tiny()
    path = str(tmp_path / "j.gguf")
    jw.write_prostt5_gguf(path, _jcfg(cfg), P.init_random_params(cfg, seed=6),
                          f16_weights=f16)
    meta, tensors = P.read_gguf(path)
    j_meta, j_tensors = J.read_gguf(path)
    assert meta == j_meta and sorted(tensors) == sorted(j_tensors)
    for name, arr in tensors.items():
        assert arr.dtype == j_tensors[name].dtype, name
        assert np.array_equal(arr, j_tensors[name]), name
    cfg2, params2, token_id = P.load_params_gguf(path)
    j_cfg2, j_params2, j_token_id = J.load_params_gguf(path)
    assert cfg2.__dict__ == j_cfg2.__dict__ and token_id == j_token_id
    assert np.array_equal(params2["layers"][1]["ffn_down"],
                          j_params2["layers"][1]["ffn_down"])


def test_params_from_numpy_refuses_shapes_off_the_config():
    cfg = P.ProstT5Config.tiny()
    params = P.init_random_params(cfg, seed=1)
    wider = P.ProstT5Config(**{**cfg.__dict__, "d_ff": cfg.d_ff * 2})
    with pytest.raises(ValueError, match="do not fit"):
        P.params_from_numpy(wider, params, CPU)


def test_release_manifest_pins_loader(golden_dir):
    """map_gguf_params against the pinned release tensor table
    (tests/golden/prostt5_manifest.json): the release hparams, no tensor
    requested outside the manifest, every required tensor consumed."""
    with open(golden_dir / "prostt5_manifest.json") as f:
        man = json.load(f)
    hp = {k: v["value"] for k, v in man["hparams"].items() if k != "arch"}
    L = hp["num_layers"]
    tensors = {}
    for name, spec in man["tensors"].items():
        shape = tuple(hp["vocab_size"] if d == "n_vocab" else d
                      for d in spec["shape"])
        names = ([name.replace("{i}", str(i)) for i in range(L)]
                 if "{i}" in name else [name])
        for nm in names:
            if not spec["required"] and ("attn_rel_b" not in nm
                                         or ".0." not in nm):
                continue
            tensors[nm] = np.zeros(shape, dtype=np.float16)
    meta = dict(man["metadata_keys"])
    meta["general.architecture"] = "t5encoder"
    meta["tokenizer.ggml.tokens"] = ["<pad>", "</s>", "<unk>"] + [
        "tok%d" % i for i in range(hp["vocab_size"] - 3)]
    touched = set()

    class Tracking(dict):
        def __getitem__(self, k):
            touched.add(k)
            return dict.__getitem__(self, k)

        def get(self, k, default=None):
            touched.add(k)
            return dict.get(self, k, default)

    cfg, params, _ = P.map_gguf_params(meta, Tracking(tensors))
    assert (cfg.d_model, cfg.num_layers, cfg.num_heads, cfg.d_kv, cfg.d_ff,
            cfg.rel_buckets, cfg.vocab_size) == (
        hp["d_model"], L, hp["num_heads"], hp["d_kv"], hp["d_ff"],
        hp["rel_buckets"], hp["vocab_size"])
    assert len(params["layers"]) == L
    assert params["conv0_w"].shape == (32, 1024, 1, 7)
    assert params["conv3_w"].shape == (20, 32, 1, 7)
    assert params["rel_bias"].shape == (hp["rel_buckets"], hp["num_heads"])
    assert params["layers"][0]["wq"].shape == (1024, 4096)
    assert params["layers"][0]["ffn_down"].shape == (16384, 1024)
    release = set(tensors) | {name.replace("{i}", str(i))
                              for name in man["tensors"] for i in range(L)}
    for k in touched:
        assert (k in release or k.count(".") < 2
                or k.startswith("conv1d.")), k
    required = {nm for name, spec in man["tensors"].items() if spec["required"]
                for nm in ([name.replace("{i}", str(i)) for i in range(L)]
                           if "{i}" in name else [name])}
    assert not required - touched


@pytest.fixture(scope="module")
def release_gguf(tmp_path_factory):
    """A release-shaped model (true widths and vocab, 2 layers) written by
    JAX's writer as the release stores it: f16 matmul weights, f32 norms."""
    d = tmp_path_factory.mktemp("prostt5_release")
    path = str(d / "release2.gguf")
    jw.write_prostt5_gguf(path, _jcfg(RELEASE_2),
                          P.init_random_params(RELEASE_2, seed=3),
                          f16_weights=True)
    return path


def _jax_logits(model, seqs):
    """JAX's logits of `seqs` in ProstT5.predict's batches: {index: [L, 20]}."""
    out = {}
    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
    for start in range(0, len(order), 8):
        idx = order[start:start + 8]
        max_t = max(len(seqs[i]) for i in idx) + 2
        pad_to = max(16, 1 << (max_t - 1).bit_length())
        toks = np.stack([model.tokenize(seqs[i], pad_to) for i in idx])
        mask = np.zeros_like(toks, dtype=bool)
        for row, i in enumerate(idx):
            mask[row, :len(seqs[i]) + 2] = True
        logits = np.asarray(model._forward(pad_to)(model.params, toks, mask))
        for row, i in enumerate(idx):
            out[i] = logits[row, :len(seqs[i]), :20]
    return out


def _port_logits(model, seqs):
    out = {}
    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
    for start in range(0, len(order), 8):
        idx = order[start:start + 8]
        logits = model.encoder(*model.batch([seqs[i] for i in idx])).numpy()
        for row, i in enumerate(idx):
            out[i] = logits[row, :len(seqs[i]), :20]
    return out


def _flat(logits_by_seq):
    return np.concatenate([logits_by_seq[i] for i in sorted(logits_by_seq)])


@pytest.fixture(scope="module")
def release_models(release_gguf):
    jm = J.ProstT5(model_file=release_gguf)
    pm = P.ProstT5(model_file=release_gguf, device="cpu")
    j_logits, p_logits = _jax_logits(jm, SEQS), _port_logits(pm, SEQS)
    return dict(jax=jm, port=pm, j_logits=j_logits,
                d=float(np.abs(_flat(j_logits) - _flat(p_logits)).max()))


def test_release_shaped_gguf_predicts_jax_letters(release_models):
    """From the release-shaped f16 GGUF both packages predict the same 3Di
    letters under the margin rule; predict is the argmax of those logits."""
    jm, pm = release_models["jax"], release_models["port"]
    j_pred, p_pred = jm.predict(SEQS), pm.predict(SEQS)
    assert [len(s) for s in p_pred] == [len(s) for s in SEQS]
    p_logits = _port_logits(pm, SEQS)
    assert p_pred == ["".join(J.THREE_DI[k] for k in p_logits[i].argmax(-1))
                      for i in range(len(SEQS))]
    j_flat = _flat(release_models["j_logits"])
    valid = np.ones(len(j_flat), bool)
    _, differ = _margin_rule(j_flat, _flat(p_logits), valid, "release f16")
    assert differ == sum(a != b for x, y in zip(j_pred, p_pred)
                         for a, b in zip(x, y))
    assert pm.encoder.layers[0].wq.dtype == torch.bfloat16
    assert pm.encoder.conv0_w.dtype == torch.float32


def _fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">seq{(i * 7) % len(seqs)} entry {i}\n{s}\n")
    return str(path)


def test_createdb_prostt5_matches_jax(tmp_path, release_gguf, release_models):
    """`createdb --prostt5-model --device cpu` through the port's CLI against
    JAX's create_db on the same FASTA: every DB file equal but ss.npy, whose
    letters follow the margin rule."""
    fasta = _fasta(tmp_path / "seqs.fasta", SEQS)
    jcreate_db([fasta], str(tmp_path / "jax"), prostt5_model=release_gguf)
    assert tmain(["createdb", fasta, str(tmp_path / "port"), "--prostt5-model",
                  release_gguf, "--device", "cpu", *QUIET]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "ca.npy" not in names
    for n in names:
        if n != "ss.npy":
            assert ((tmp_path / "jax" / n).read_bytes()
                    == (tmp_path / "port" / n).read_bytes()), n
    jdb, pdb = load_db(str(tmp_path / "jax")), load_db(str(tmp_path / "port"))
    assert np.array_equal(jdb.offsets, pdb.offsets)
    d, j_logits = release_models["d"], release_models["j_logits"]
    for e in range(jdb.size):
        i = int(jdb.headers[e].split()[2])
        js = np.sort(j_logits[i], -1)
        margin = js[:, -1] - js[:, -2]
        differ = jdb.get_ss(e) != pdb.get_ss(e)
        assert not (differ & (margin > 2 * d)).any(), jdb.names[e]


def test_createdb_refuses_missing_cuda(tmp_path, release_gguf):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fasta = _fasta(tmp_path / "seqs.fasta", SEQS[:2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain(["createdb", fasta, str(tmp_path / "db"), "--prostt5-model",
               release_gguf, *QUIET])


@pytest.fixture(scope="module")
def seq_only_dbs(golden_dir, tmp_path_factory):
    """The fixture structures as a DB, and a JAX-made ProstT5 DB of their
    amino-acid strings (a tiny model: the search, not the model, is held)."""
    d = tmp_path_factory.mktemp("prostt5_search")
    pdbs = sorted(str(p) for p in (golden_dir / "msa" / "sup").glob("*.pdb"))
    assert jmain(["createdb", *pdbs, str(d / "structures"), *QUIET]) == 0
    sdb = load_db(str(d / "structures"))
    with open(d / "seqs.fasta", "w") as f:
        for i in range(sdb.size):
            f.write(f">{sdb.names[i]}_seq\n{sdb.get_aa_str(i)}\n")
    gguf = str(d / "small.gguf")
    jw.write_prostt5_gguf(gguf, _jcfg(SMALL), P.init_random_params(SMALL, 5))
    jcreate_db([str(d / "seqs.fasta")], str(d / "seqonly"), prostt5_model=gguf)
    return d


@pytest.mark.parametrize("target", ["structures", "seqonly"])
def test_search_of_prostt5_db_matches_jax(seq_only_dbs, target):
    """`search --gpu 1 -a` then `convertalis` of the ProstT5 DB against the
    structure DB and against itself: the port's m8 equals JAX's; columns
    that need C-alpha coordinates are refused."""
    d = seq_only_dbs
    q, t = str(d / "seqonly"), str(d / target)
    m8 = {}
    for side, main, extra in (("jax", jmain, []),
                              ("port", tmain, ["--device", "cpu"])):
        res = str(d / f"{side}_{target}")
        assert main(["search", q, t, res, res + "_tmp", "--gpu", "1", "-a",
                     *QUIET, *extra]) == 0
        assert main(["convertalis", q, t, res, res + ".m8", *QUIET]) == 0
        with open(res + ".m8", "rb") as f:
            m8[side] = f.read()
    assert m8["port"] == m8["jax"]
    assert m8["port"].count(b"\n") >= 16
    with pytest.raises(ValueError, match="C-alpha"):
        tmain(["convertalis", q, t, str(d / f"port_{target}"),
               str(d / "x.m8"), "--format-output", "query,target,lddt",
               *QUIET])
