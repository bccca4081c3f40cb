"""The hybrid, encoder-decoder and VLM families of the port against the JAX
reference, function by function, on the same numpy inputs.

`attention_swa_block` (and `attention`'s dispatch to it),
`sinusoid_pos_emb`, `attn_cross_full` and `ring_decode_attention` (the
flash-decode kernel's plain version over the whole ring at
``min(pos, w - 1)``, against the reference's masked jnp ring, over 2w
steps) at 2e-5 in f32; `make_prompts`' frame and patch draws bitwise;
`params_from_numpy` on the new leaves; `param_specs` at the full size of
every shipped config (names, shapes, parameter count), with no tensor
allocated; and `serve(engine="dense")` on the CPU for every shipped config
reduced. The model-level parity (prefill, decode, greedy tokens) is in
`test_torch_model_dense.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_serve
from repro.models import build_model as ref_build_model
from repro.models import common as ref_common
from repro.models import lm as ref_lm
from repro_torch.configs import ALL_ARCH_NAMES, get_config
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve as port_serve
from repro_torch.models import build_model, common, lm
from repro_torch.models.params import params_from_numpy

TOL = 2e-5
F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


# ------------------------------------------------------------ layer library


@pytest.mark.parametrize("s,window,chunk", [(64, 32, 32), (128, 32, 32),
                                            (96, 16, 32), (128, 64, 64)])
def test_attention_swa_block_matches_reference(s, window, chunk):
    rng = np.random.RandomState(s + window)
    q = rng.randn(2, s, 6, 16).astype(np.float32)
    k, v = (rng.randn(2, s, 2, 16).astype(np.float32) for _ in range(2))
    pos = np.arange(s)
    want = ref_common.attention_swa_block(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_pos=jnp.asarray(pos), window=window, chunk=chunk)
    got = common.attention_swa_block(_t(q), _t(k), _t(v), q_pos=_t(pos),
                                     window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # the dispatch: causal windowed self-attention over >= 2 whole chunks
    # takes the block form in both packages; the same mask as the naive one
    kw = dict(causal=True, window=window, chunk=chunk)
    want = ref_common.attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_pos=jnp.asarray(pos),
                                k_pos=jnp.asarray(pos), **kw)
    got = common.attention(_t(q), _t(k), _t(v), q_pos=_t(pos), k_pos=_t(pos),
                           **kw)
    naive = common.attention_naive(_t(q), _t(k), _t(v), q_pos=_t(pos),
                                   k_pos=_t(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), rtol=TOL, atol=TOL)


def test_attention_dispatch_takes_the_swa_block(monkeypatch):
    calls = []
    real = common.attention_swa_block
    monkeypatch.setattr(common, "attention_swa_block",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    q = torch.randn(1, 64, 2, 16)
    pos = torch.arange(64)
    common.attention(q, q, q, q_pos=pos, k_pos=pos, window=32, chunk=32)
    assert calls == [dict(q_pos=pos, window=32, chunk=32)]
    for kw in (dict(window=32, chunk=32, prefix=4),   # a VLM prefix
               dict(window=32, chunk=64),             # one chunk
               dict(window=0, chunk=32)):             # no window
        common.attention(q, q, q, q_pos=pos, k_pos=pos, **kw)
    assert len(calls) == 1


@pytest.mark.parametrize("seq,d,dtype,atol", [
    (37, 64, "float32", TOL),
    # whisper-medium's encoder at 1024 frames: angles up to 1023 rad, whose
    # own f32 spacing is 6.1e-5, so two sin/cos implementations differ by
    # up to about that much
    (1024, 1024, "float32", 2e-4),
    (300, 64, "bfloat16", 1e-2),          # one bf16 step at |value| ~1
])
def test_sinusoid_pos_emb_matches_reference(seq, d, dtype, atol):
    want = np.asarray(ref_common.sinusoid_pos_emb(seq, d, jnp.dtype(dtype)),
                      np.float32)
    got = common.sinusoid_pos_emb(seq, d, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (seq, d)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("bias", [False, True])
def test_attn_cross_full_matches_reference(bias):
    cfg = get_config("whisper-medium").reduced().replace(use_bias=bias, **F32)
    ref_cfg = ref_get_config("whisper-medium").reduced().replace(
        use_bias=bias, **F32)
    rng = np.random.RandomState(3)
    p = {k: (rng.randn(*s.shape) * 0.1).astype(np.float32)
         for k, s in lm._attn_specs(cfg).items()}
    x = rng.randn(2, 9, cfg.d_model).astype(np.float32)
    enc = rng.randn(2, 20, cfg.d_model).astype(np.float32)
    want, (wk, wv) = ref_lm.attn_cross_full(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(enc), ref_cfg, kv_out=True)
    got, (k, v) = lm.attn_cross_full({k: _t(v) for k, v in p.items()}, _t(x),
                                     _t(enc), cfg)
    for a, b in ((got, want), (k, wk), (v, wv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("window,tensor_pos", [(16, True), (16, False),
                                               (40, True)])
def test_ring_decode_attention_matches_reference(window, tensor_pos):
    """2w steps from an empty ring (hymba's head layout: 5 query heads a KV
    head): each output and the ring the step wrote, through the wrap. The
    port runs the flash-decode kernel's plain version here."""
    rng = np.random.RandomState(window)
    b, kh, g, d = 2, 2, 5, 16
    kc = np.zeros((b, window, kh, d), np.float32)
    ref_k, ref_v = jnp.asarray(kc), jnp.asarray(kc)
    tk, tv = _t(kc), _t(kc)
    for pos in range(2 * window):
        q = rng.randn(b, 1, kh * g, d).astype(np.float32)
        nk, nv = (rng.randn(b, 1, kh, d).astype(np.float32) for _ in range(2))
        want, ref_k, ref_v = ref_lm.ring_decode_attention(
            jnp.asarray(q), ref_k, ref_v, jnp.asarray(nk), jnp.asarray(nv),
            jnp.asarray(pos, jnp.int32), window)
        p = torch.tensor(pos, dtype=torch.int32) if tensor_pos else pos
        got, ok, ov = lm.ring_decode_attention(_t(q), tk, tv, _t(nk), _t(nv),
                                               p, window)
        assert ok is tk and ov is tv                 # written in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(ref_k))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(ref_v))
    assert launch_counts()["flash_decode"] == 0      # CPU tensors: plain


# ---------------------------------------------------- prompts and params


@pytest.mark.parametrize("arch,key", [("whisper-medium", "frames"),
                                      ("paligemma-3b", "patches")])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_make_prompts_draws_the_reference_frontend(arch, key, dtype):
    ref_b, ref_text = ref_serve.make_prompts(
        ref_get_config(arch).reduced().replace(dtype=dtype), 3, 64,
        np.random.default_rng(7))
    b, text = port_serve.make_prompts(
        get_config(arch).reduced().replace(dtype=dtype), 3, 64,
        np.random.default_rng(7), "cpu")
    assert text == ref_text and set(b) == {"tokens", key}
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  np.asarray(ref_b["tokens"]))
    assert b[key].dtype == getattr(torch, dtype)
    assert tuple(b[key].shape) == ref_b[key].shape
    np.testing.assert_array_equal(b[key].float().numpy(),
                                  np.asarray(ref_b[key], np.float32))


@pytest.mark.parametrize("arch,new_leaves", [
    ("hymba-1.5b", {"layers.ssm.in_proj", "layers.ssm.A_log",
                    "layers.attn.wq"}),
    ("whisper-medium", {"enc_layers.attn.wq", "enc_layers.mlp.w_up",
                        "enc_norm", "dec_pos_embed", "layers.cross.wk",
                        "layers.cross.bk"}),
    ("paligemma-3b", {"patch_proj", "layers.attn.wk"}),
])
def test_params_from_numpy_carries_the_new_leaves(arch, new_leaves):
    ref_model = ref_build_model(ref_get_config(arch).reduced())
    ref_params = jax.tree.map(np.asarray, ref_model.init(
        jax.random.PRNGKey(1)))
    cfg = get_config(arch).reduced()
    params = params_from_numpy(ref_params, cfg, "cpu")
    ours, theirs = dict(_flat(params)), dict(_flat(ref_params))
    assert set(ours) == set(theirs) and new_leaves <= set(ours)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(theirs[k], np.float32))
    # a leaf missing from the reference's tree is refused
    del ref_params[sorted(new_leaves)[0].split(".")[0]]
    with pytest.raises(ValueError):
        params_from_numpy(ref_params, cfg, "cpu")


@pytest.mark.parametrize("arch", ALL_ARCH_NAMES)
def test_param_specs_match_reference_at_full_size(arch):
    """Names, shapes, dtypes and inits of every leaf, and the parameter
    count, at the shipped config (specs only: nothing is allocated)."""
    specs = build_model(get_config(arch)).param_specs()
    ref_model = ref_build_model(ref_get_config(arch))
    ref_specs = ref_model.param_specs()
    ours, theirs = dict(_flat(specs)), dict(_flat(ref_specs))
    assert set(ours) == set(theirs)
    for k, s in ours.items():
        r = theirs[k]
        assert (s.shape, s.axes, s.init, s.scale) == (
            tuple(r.shape), tuple(r.axes), r.init, r.scale), k
        assert s.dtype == jnp.dtype(r.dtype).name, k
    assert build_model(get_config(arch)).n_params() == ref_model.n_params()


@pytest.mark.parametrize("arch", ALL_ARCH_NAMES)
def test_serve_dense_runs_every_arch_reduced_on_the_cpu(arch):
    cfg = get_config(arch).reduced()
    stats = port_serve.serve(cfg, batch=2, prompt_len=32, gen=3,
                             device="cpu")
    assert stats["engine"] == "dense" and stats["generated_shape"] == (2, 3)
    assert all(0 <= t < cfg.vocab for row in stats["generated"] for t in row)
    assert stats["substrate"]["backoffs"] == 0


def test_hymba_prefill_takes_the_swa_block_and_decode_wraps_the_ring(
        monkeypatch):
    """Reduced hymba at 64 prompt tokens: each layer's prefill attention is
    the block form, its cache a ring of 32 slots; the first decode step
    writes slot 64 % 32 = 0 of every layer's ring."""
    calls = []
    real = common.attention_swa_block
    monkeypatch.setattr(common, "attention_swa_block",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    cfg = get_config("hymba-1.5b").reduced().replace(**F32)
    model = build_model(cfg)
    g = torch.Generator()
    g.manual_seed(0)
    params = model.init(g, "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=g, dtype=torch.int32)
    cache, _ = model.prefill(params, {"tokens": toks}, pad_to=80)
    assert len(calls) == cfg.n_layers
    ring = cache["layers"]["k"]
    assert ring.shape[2] == cfg.sliding_window == 32
    before = ring.clone()
    model.decode_step(params, cache, {"tokens": toks[:, :1]})
    changed = (ring != before).flatten(3).any(-1)       # [L, B, slots]
    assert changed[:, :, 0].all() and not changed[:, :, 1:].any()

