"""The dense serving engine of the port against the JAX reference.

Reduced yi-6b (dense), granite-moe-1b-a400m (MoE) and mamba2-130m (SSM),
in f32, with the reference's parameters bridged through numpy
(`params_from_numpy`): prefill logits and caches, and four decode steps,
agree within the reference's f32 parity bound (2e-3); the greedy token
streams of `prefill` + `timed_decode_loop` are identical to the
reference's; `serve(engine="dense")` runs on the CPU when asked, and
raises RuntimeError by default where there is no CUDA device. The mamba2
prompts are a multiple of its reduced `ssm_chunk` (16), so its prefill
goes the SSD-scan kernel's route (its plain version on CPU tensors).
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
from repro_torch.configs import get_config
from repro_torch.core import autotune
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve as port_serve
from repro_torch.models import build_model
from repro_torch.models.params import params_from_numpy

TOL = 2e-3
F32 = dict(dtype="float32", param_dtype="float32")
ARCHS = ["yi-6b", "granite-moe-1b-a400m", "mamba2-130m"]


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
    if cfg.family == "ssm":
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


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab,
                                               (b, s)).astype(np.int32)


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
def test_families_of_a_later_slice_are_refused(arch):
    with pytest.raises(NotImplementedError):
        build_model(get_config(arch).reduced()).param_specs()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    """Prefill logits and caches (padded past the prompt), then four decode
    steps: logits and the caches they write, at 2e-3."""
    ref_model, ref_params, model, params, cfg = _bridge(arch)
    toks = _tokens(cfg, 2, 32, 1)
    pad_to = 40
    ref_cache, ref_logits = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(toks)}, pad_to=pad_to)
    cache, logits = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                  pad_to=pad_to)
    assert logits.shape == ref_logits.shape and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=TOL, atol=TOL)
    assert cache["pos"] == int(ref_cache["pos"]) == 32
    assert set(cache["layers"]) == set(ref_cache["layers"])
    for key, leaf in cache["layers"].items():
        np.testing.assert_allclose(leaf.float().numpy(),
                                   np.asarray(ref_cache["layers"][key],
                                              np.float32),
                                   rtol=TOL, atol=TOL, err_msg=key)
    if cfg.family == "ssm":
        assert autotune.last_choice("ssd_scan") is not None   # K4's route
    else:
        assert cache["layers"]["k"].shape[2] == pad_to
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
    assert cache["pos"] == int(ref_cache["pos"]) == 36
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
    batch, text_len, gen = 2, 48, 10
    toks = _tokens(cfg, batch, text_len, 4)

    ref_cache, ref_logits = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(toks)}, pad_to=text_len + gen)
    first = jnp.argmax(ref_logits[:, -1:], axis=-1).astype(jnp.int32)
    ref_out, _, _ = ref_serve.timed_decode_loop(
        ref_serve.jit_decode_step(ref_model), ref_params, ref_cache, first,
        steps=gen - 1, make_batch=lambda t, i: {"tokens": t})
    want = np.concatenate([np.asarray(t) for t in ref_out], axis=1)

    cache, logits = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                  pad_to=text_len + gen)
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
    if arch != "mamba2-130m":
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
    toks = _tokens(cfg, 2, 32, 6)
    ref_cache, ref_logits = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(toks)}, pad_to=48)
    cache, logits = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                  pad_to=48)
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
    pos = cache["pos"]
    assert isinstance(pos, torch.Tensor) and pos.dim() == 0
    assert pos.dtype == torch.int32 and int(pos) == int(ref_cache["pos"]) == 40
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
               lm.run_layers_decode, lm.decode_step_paged,
               lm.paged_attn_decode, common._single_decode,
               common.paged_cache_append, common.paged_decode_attention):
        src = inspect.getsource(fn)
        assert "int(pos" not in src and ".cpu()" not in src, fn.__name__
        assert ".item()" not in src and ".tolist()" not in src, fn.__name__
