"""The dense serving engine of the port against the JAX reference.

Reduced yi-6b (dense), granite-moe-1b-a400m (MoE), mamba2-130m (SSM),
hymba-1.5b (hybrid), whisper-medium (encoder-decoder) and paligemma-3b
(VLM), in f32, with the reference's parameters bridged through numpy
(`params_from_numpy`): prefill logits and every cache leaf, and four
decode steps, agree within the reference's f32 parity bound (2e-3); the
greedy token streams of `prefill` + `timed_decode_loop` are identical to
the reference's; `serve(engine="dense")` runs on the CPU when asked, and
raises RuntimeError by default where there is no CUDA device. The mamba2
prompts are a multiple of its reduced `ssm_chunk` (16), so its prefill
goes the SSD-scan kernel's route (its plain version on CPU tensors).
Reduced hymba (window 32, `attn_chunk` 32) takes prompts of 64 tokens, so
its prefill runs the sliding-window block attention and its ring wraps in
the first decode step. whisper's prompts are frame embeddings with a
quarter as many text tokens, paligemma's patch embeddings before the
text (`configs.token_split`).
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
from repro_torch.configs import get_config, token_split
from repro_torch.core import autotune
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve as port_serve
from repro_torch.models import build_model
from repro_torch.models.params import params_from_numpy

TOL = 2e-3
F32 = dict(dtype="float32", param_dtype="float32")
ARCHS = ["yi-6b", "granite-moe-1b-a400m", "mamba2-130m", "hymba-1.5b",
         "whisper-medium", "paligemma-3b"]
# prompt positions (frontend + text): hymba's reach its swa block (2 x 32)
PROMPT = {"hymba-1.5b": 64}


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _bridge(arch, seed=0):
    ref_cfg = ref_get_config(arch).reduced().replace(**F32)
    cfg = get_config(arch).reduced().replace(**F32)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed))
    if cfg.ssm:
        # random A_log / dt_bias / D: the init's zeros and ones hide mistakes
        rng = np.random.RandomState(seed + 7)
        ssm_p = dict(ref_params["layers"]["ssm"])
        for k in ("A_log", "dt_bias", "D"):
            ssm_p[k] = jnp.asarray(rng.randn(*ssm_p[k].shape) * 0.5,
                                   jnp.float32)
        ref_params = dict(ref_params)
        ref_params["layers"] = dict(ref_params["layers"], ssm=ssm_p)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    return ref_model, ref_params, build_model(cfg), params, cfg


def _prompts(cfg, b, s, seed):
    """numpy inputs of a prompt of `s` positions: the text tokens, and the
    frame (enc-dec) or patch (VLM) embeddings of a stub frontend. Returns
    (the reference's batch, the port's, text length, decode position)."""
    front, text = token_split(cfg, s)
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab, (b, text)).astype(np.int32)}
    if cfg.enc_dec or cfg.vlm:
        emb = (rng.randn(b, front, cfg.d_model) * 0.02).astype(np.float32)
        batch["frames" if cfg.enc_dec else "patches"] = emb
    pos = text + (front if cfg.vlm else 0)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()}, text, pos)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def test_mamba2_params_bridge_keeps_names_and_shapes():
    ref_model, ref_params, model, params, cfg = _bridge("mamba2-130m")
    flat_ref = dict(_flat(jax.tree.map(np.asarray, ref_params)))
    ours = dict(_flat(params))
    assert set(ours) == set(flat_ref)
    assert {"layers.ssm.in_proj", "layers.ssm.conv_w", "layers.ssm_ln",
            "layers.ssm.A_log"} <= set(ours)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), flat_ref[k])
    assert model.n_params() == ref_model.n_params()
    # the full config declares what the reference declares
    full = build_model(get_config("mamba2-130m"))
    assert full.n_params() == ref_build_model(
        ref_get_config("mamba2-130m")).n_params()


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-medium",
                                  "paligemma-3b"])
def test_paged_engine_refuses_the_dense_only_families(arch):
    """The hybrid, enc-dec and VLM archs run on the dense engine only, as
    in the reference (`supports_paged_decode`): the paged engine and the
    paged steps raise ValueError for them."""
    from repro_torch.serve import PagedServingEngine

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    assert not model.supports_paged_decode()
    assert not ref_build_model(ref_get_config(arch).reduced()
                               ).supports_paged_decode()
    with pytest.raises(ValueError):
        PagedServingEngine(cfg, device="cpu")
    with pytest.raises(ValueError):
        model.decode_step_paged({}, None, None, None, None,
                                {"tokens": torch.zeros(1, 1)})
    with pytest.raises(ValueError):
        model.prefill_chunk_paged({}, None, None, None, 0,
                                  {"tokens": torch.zeros(1, 4)}, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    """Prefill logits and every cache leaf (K/V padded past the prompt, a
    ring at its window, SSM and conv states, cross K/V), then four decode
    steps: logits and the caches they write, at 2e-3."""
    ref_model, ref_params, model, params, cfg = _bridge(arch)
    ref_batch, batch, text, pos = _prompts(cfg, 2, PROMPT.get(arch, 32), 1)
    pad_to = text + 8
    ref_cache, ref_logits = ref_model.prefill(ref_params, ref_batch,
                                              pad_to=pad_to)
    cache, logits = model.prefill(params, batch, pad_to=pad_to)
    assert logits.shape == ref_logits.shape and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=TOL, atol=TOL)
    assert cache["pos"] == int(ref_cache["pos"]) == pos
    assert set(cache["layers"]) == set(ref_cache["layers"])
    for key, leaf in cache["layers"].items():
        assert tuple(leaf.shape) == ref_cache["layers"][key].shape, key
        np.testing.assert_allclose(leaf.float().numpy(),
                                   np.asarray(ref_cache["layers"][key],
                                              np.float32),
                                   rtol=TOL, atol=TOL, err_msg=key)
    if cfg.ssm:
        assert autotune.last_choice("ssd_scan") is not None   # K4's route
    if cfg.sliding_window:
        assert cache["layers"]["k"].shape[2] == cfg.sliding_window  # a ring
    elif cfg.family != "ssm":
        assert cache["layers"]["k"].shape[2] == pos + 8
    leaves = {k: v for k, v in cache["layers"].items()}
    rng = np.random.RandomState(2)
    for _ in range(4):
        step = rng.randint(0, cfg.vocab, (2, 1)).astype(np.int32)
        ref_logits, ref_cache = ref_model.decode_step(
            ref_params, ref_cache, {"tokens": jnp.asarray(step)})
        logits, cache = model.decode_step(params, cache,
                                          {"tokens": torch.from_numpy(step)})
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=TOL, atol=TOL)
    assert cache["pos"] == int(ref_cache["pos"]) == pos + 4
    for key, leaf in cache["layers"].items():
        assert leaf is leaves[key]              # updated in place
        np.testing.assert_allclose(leaf.float().numpy(),
                                   np.asarray(ref_cache["layers"][key],
                                              np.float32),
                                   rtol=TOL, atol=TOL, err_msg=key)
    assert launch_counts()["flash_decode"] == 0    # CPU tensors: plain paths
    assert launch_counts()["ssd_scan"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(arch):
    """prefill + timed_decode_loop in both packages, the reference's jitted
    step: identical greedy streams."""
    ref_model, ref_params, model, params, cfg = _bridge(arch, seed=3)
    batch, gen = 2, 10
    ref_prompts, prompts, text_len, _ = _prompts(
        cfg, batch, PROMPT.get(arch, 48), 4)

    ref_cache, ref_logits = ref_model.prefill(
        ref_params, ref_prompts, pad_to=text_len + gen)
    first = jnp.argmax(ref_logits[:, -1:], axis=-1).astype(jnp.int32)
    ref_out, _, _ = ref_serve.timed_decode_loop(
        ref_serve.jit_decode_step(ref_model), ref_params, ref_cache, first,
        steps=gen - 1, make_batch=lambda t, i: {"tokens": t})
    want = np.concatenate([np.asarray(t) for t in ref_out], axis=1)

    cache, logits = model.prefill(params, prompts, pad_to=text_len + gen)
    first = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    out, last, lat = port_serve.timed_decode_loop(
        model.decode_step, params, cache, first, steps=gen - 1,
        make_batch=lambda t, i: {"tokens": t})
    got = torch.cat(out, dim=1).numpy()
    assert got.shape == (batch, gen) and len(lat) == gen - 1
    np.testing.assert_array_equal(got, want)


def test_make_prompts_draws_the_reference_tokens():
    cfg = get_config("mamba2-130m").reduced()
    ref_b, ref_text = ref_serve.make_prompts(
        ref_get_config("mamba2-130m").reduced(), 3, 32,
        np.random.default_rng(5))
    b, text = port_serve.make_prompts(cfg, 3, 32, np.random.default_rng(5),
                                      "cpu")
    assert text == ref_text == 32
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  np.asarray(ref_b["tokens"]))
    assert b["tokens"].dtype == torch.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_dense_runs_on_the_cpu_when_asked(arch):
    cfg = get_config(arch).reduced().replace(**F32)
    stats = port_serve.serve(cfg, batch=2, prompt_len=32, gen=4,
                             device="cpu")
    assert stats["engine"] == "dense" and stats["device"] == "cpu"
    assert stats["generated_shape"] == (2, 4)
    assert all(0 <= t < cfg.vocab for row in stats["generated"] for t in row)
    assert stats["p50_ms"] > 0 and stats["decode_tok_per_s"] > 0
    # the paged engine is one flag away, for the archs it serves
    if build_model(cfg).supports_paged_decode():
        paged = port_serve.serve(cfg, batch=2, prompt_len=12, gen=3,
                                 engine="paged", block_size=4, device="cpu")
        assert paged["states"] == ["finished"] * 2


def test_serve_dense_needs_a_device_it_can_use():
    cfg = get_config("mamba2-130m").reduced()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.serve(cfg, batch=2, prompt_len=32, gen=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.main(["--arch", "mamba2-130m", "--reduced"])
    with pytest.raises(ValueError):
        port_serve.serve(cfg, batch=2, prompt_len=32, gen=4, device="cpu",
                         chaos=1)


def test_cli_runs_the_dense_engine_by_default(capsys):
    stats = port_serve.main(["--arch", "mamba2-130m", "--reduced",
                             "--device", "cpu", "--batch", "2",
                             "--prompt-len", "32", "--gen", "3"])
    assert stats["engine"] == "dense"
    assert '"engine": "dense"' in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_jit_decode_step_matches_reference(arch):
    """`jit_decode_step` (on CPU tensors `model.decode_step`; on the card a
    replayed CUDA graph) against the reference's jitted step over eight
    greedy steps from the same prefill: logits and caches at 2e-3, tokens
    identical, and the cache's pos equal, a 0-d int32 tensor."""
    ref_model, ref_params, model, params, cfg = _bridge(arch, seed=5)
    ref_prompts, prompts, text, pos = _prompts(cfg, 2, PROMPT.get(arch, 32),
                                               6)
    ref_cache, ref_logits = ref_model.prefill(ref_params, ref_prompts,
                                              pad_to=text + 16)
    cache, logits = model.prefill(params, prompts, pad_to=text + 16)
    ref_decode = ref_serve.jit_decode_step(ref_model)
    decode = port_serve.jit_decode_step(model)
    ref_tok = jnp.argmax(ref_logits[:, -1:], axis=-1).astype(jnp.int32)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    for _ in range(8):
        ref_logits, ref_cache = ref_decode(ref_params, ref_cache,
                                           {"tokens": ref_tok})
        logits, cache = decode(params, cache, {"tokens": tok})
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=TOL, atol=TOL)
        ref_tok = jnp.argmax(ref_logits, axis=-1).astype(jnp.int32)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    want_pos, pos = pos, cache["pos"]
    assert isinstance(pos, torch.Tensor) and pos.dim() == 0
    assert pos.dtype == torch.int32
    assert int(pos) == int(ref_cache["pos"]) == want_pos + 8
    for key, leaf in cache["layers"].items():
        np.testing.assert_allclose(leaf.float().numpy(),
                                   np.asarray(ref_cache["layers"][key],
                                              np.float32),
                                   rtol=TOL, atol=TOL, err_msg=key)
    assert decode.graph.captures == 0          # CPU tensors: eager steps


def test_decode_steps_read_no_position_on_the_host():
    """The dense and paged decode steps keep pos on the device: no int() of
    a position and no read back inside them (the paged round's one read of
    its next tokens is the engine's, after the replay)."""
    import inspect

    from repro_torch.models import common, lm

    for fn in (lm.decode_step, lm.attn_decode, lm.block_decode,
               lm.run_layers_decode, lm.ring_decode_attention,
               lm.decode_step_paged,
               lm.paged_attn_decode, common._single_decode,
               common.paged_cache_append, common.paged_decode_attention):
        src = inspect.getsource(fn)
        assert "int(pos" not in src and ".cpu()" not in src, fn.__name__
        assert ".item()" not in src and ".tolist()" not in src, fn.__name__
