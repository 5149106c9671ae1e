"""The port's LM stack (dense, MoE and hybrid) against the JAX package, on
the CPU.

The reference's ``init_params`` draws the weights; ``params_from_numpy``
carries them into the port unchanged (the weight bridge: both trees have
the same keys and stacked ``[R, ...]`` layout).  The same numpy-seeded
tokens then go through both packages' prefill, hidden-state forward and
decode step, and through the serve loop: the dense archs and the MoE
archs (qwen3-moe-235b-a22b, and arctic-480b with its dense residual
branch), whose routing must pick the same experts in both packages, and
the hybrid jamba-v0.1-52b (one repeat of its 8-block pattern: mamba,
mamba_moe and attn blocks; the decode cache holds each mamba block's
SSM state and conv window); and xlstm-350m (its spec trees, input
shapes, the reduced prefill and decode; its blocks and serving in
depth: ``tests/test_torch_xlstm.py``).

Tolerances: logits and hidden states atol 1e-4 / rtol 1e-4 (float32
matrix products and softmax sums in another order than XLA's, through 2
layers of O(1) activations); decode caches 1e-4; greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import decode_step as j_decode_step
from repro.models import param as jparam
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.core import pytree as pt
from repro_torch.launch import serve, steps
from repro_torch.models import layers as L
from repro_torch.models import param, transformer

ATOL = RTOL = 1e-4
DENSE = ["qwen1.5-0.5b", "yi-9b", "minitron-8b", "phi4-mini-3.8b"]
MOE = ["qwen3-moe-235b-a22b", "arctic-480b"]
HYBRID = ["jamba-v0.1-52b"]
XLSTM = ["xlstm-350m"]
ENC_DEC = ["whisper-tiny"]
NOT_PORTED = ["internvl2-26b"]
SMALL = {"qwen": ("qwen1.5-0.5b", {}),
         "yi-gqa": ("yi-9b", {"num_kv_heads": 2}),
         "qwen3-moe": ("qwen3-moe-235b-a22b", {}),
         "arctic": ("arctic-480b", {"num_kv_heads": 2}),
         "jamba": ("jamba-v0.1-52b",
                   {"num_layers": 1, "d_model": 64, "num_heads": 4,
                    "num_kv_heads": 2, "d_ff": 128, "vocab_size": 128}),
         "xlstm": ("xlstm-350m", {})}


def _small(name):
    arch, kw = SMALL[name]
    return (jconfigs.get_arch(arch).reduced(**kw),
            configs.get_arch(arch).reduced(**kw))


_PARAMS = {}


def _params(name):
    """The reference's seeded weights for ``name``, and the same values
    carried into the port."""
    if name not in _PARAMS:
        jcfg, _ = _small(name)
        jp = jparam.init_params(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
        numpy_tree = jax.tree_util.tree_map(np.asarray, jp)
        _PARAMS[name] = (jp, param.params_from_numpy(numpy_tree,
                                                     device="cpu"))
    return _PARAMS[name]


def _tokens(seed, vocab, B, S):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _spec_rows(tree, is_leaf):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {jax.tree_util.keystr(p): (tuple(s.shape), tuple(s.axes), s.init,
                                      s.scale) for p, s in leaves}


# ---------------------------------------------------------------------------
# Configs and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHITECTURES))
def test_arch_configs_match_reference(arch):
    """Every architecture, its reduced preset and the derived properties
    read the same in both packages."""
    j, t = jconfigs.get_arch(arch), configs.get_arch(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert (t.resolved_head_dim, t.layer_kinds, t.is_moe,
            t.supports_subquadratic_decode) == (
        j.resolved_head_dim, j.layer_kinds, j.is_moe,
        j.supports_subquadratic_decode)


def test_registry_matches_reference():
    assert configs.ALIASES == jconfigs.ALIASES
    assert sorted(configs.ARCHITECTURES) == sorted(jconfigs.ARCHITECTURES)
    for name, shape in jconfigs.INPUT_SHAPES.items():
        assert dataclasses.asdict(configs.get_shape(name)) == \
            dataclasses.asdict(shape)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("gpt-5")
    with pytest.raises(KeyError, match="unknown input shape"):
        configs.get_shape("train_8k")


@pytest.mark.parametrize("arch", DENSE + MOE + HYBRID + XLSTM + ENC_DEC)
def test_model_specs_match_reference_at_full_width(arch):
    """The full configs' spec trees -- keys, shapes, axes, initialisers
    -- and parameter counts, from the specs alone (nothing allocated)."""
    jspecs = jtf.model_specs(jconfigs.get_arch(arch))
    tspecs = transformer.model_specs(configs.get_arch(arch))
    assert _spec_rows(tspecs, lambda x: isinstance(x, param.ParamSpec)) == \
        _spec_rows(jspecs, jparam.is_spec)
    assert param.param_count(tspecs) == jparam.param_count(jspecs)


def test_qwen_parameter_count():
    """qwen1.5-0.5b in full: 155.6 M embedding + 24 x 12.85 M."""
    specs = transformer.model_specs(configs.get_arch("qwen1.5-0.5b"))
    assert param.param_count(specs) == 463_987_712
    assert param.param_count(specs["embed"]) == 151_936 * 1024


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_other_families_are_refused(arch):
    cfg = configs.get_arch(arch)
    with pytest.raises(ValueError, match="not yet ported"):
        transformer.model_specs(cfg)
    with pytest.raises(ValueError, match="not yet ported"):
        transformer.decode_cache_specs(cfg, 1, 8)


@pytest.mark.parametrize("arch", DENSE + MOE + HYBRID + XLSTM + ENC_DEC)
@pytest.mark.parametrize("shape", sorted(jconfigs.INPUT_SHAPES))
def test_step_input_specs_match_reference(arch, shape):
    jcfg, tcfg = jconfigs.get_arch(arch), configs.get_arch(arch)
    js, ts = jconfigs.get_shape(shape), configs.get_shape(shape)

    def rows(tree):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in tree.items()}

    assert rows(steps.prefill_batch_specs(tcfg, ts)) == \
        rows(jsteps.prefill_batch_specs(jcfg, js))
    assert rows(steps.decode_batch_specs(tcfg, ts)) == \
        rows(jsteps.decode_batch_specs(jcfg, js))
    jc = jax.tree_util.tree_leaves_with_path(
        jsteps.abstract_decode_cache(jcfg, js))
    tc = jax.tree_util.tree_leaves_with_path(
        steps.abstract_decode_cache(tcfg, ts),
        is_leaf=lambda x: isinstance(x, steps.ShapeDtype))
    assert [(jax.tree_util.keystr(p), tuple(s.shape),
             str(s.dtype).replace("torch.", "")) for p, s in tc] == \
        [(jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype))
         for p, s in jc]


def test_effective_cache_len_matches_reference():
    for arch in jconfigs.ARCHITECTURES:
        for n in (4096, 524_288):
            assert transformer.effective_cache_len(
                configs.get_arch(arch), n) == jtf.effective_cache_len(
                jconfigs.get_arch(arch), n)


# ---------------------------------------------------------------------------
# The weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SMALL))
def test_params_from_numpy_carries_the_lm_tree(name):
    """``params_from_numpy`` of the reference's params is a tree of the
    port's spec structure, with the reference's values bit for bit."""
    jp, tp = _params(name)
    _, tcfg = _small(name)
    specs = transformer.model_specs(tcfg)
    spec_paths = [p for p, _ in jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, param.ParamSpec))]
    tree_paths = [p for p, _ in jax.tree_util.tree_leaves_with_path(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    assert tree_paths == spec_paths
    for (p, j), t, s in zip(jax.tree_util.tree_leaves_with_path(jp),
                            pt.leaves(tp), pt.leaves(specs)):
        assert tuple(t.shape) == s.shape, jax.tree_util.keystr(p)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_init_params_draws_the_spec_tree():
    _, tcfg = _small("yi-gqa")
    specs = transformer.model_specs(tcfg)
    p = param.init_params(specs, torch.Generator().manual_seed(0),
                          device="cpu")
    assert [tuple(x.shape) for x in pt.leaves(p)] == \
        [s.shape for s in pt.leaves(specs)]
    assert float(p["stack"]["pos_0"]["ln1"].min()) == 1.0
    assert "head" in p and "bq" not in p["stack"]["pos_0"]["attn"]


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("S", [32, 200])
def test_prefill_matches_reference(name, S):
    jp, tp = _params(name)
    jcfg, tcfg = _small(name)
    toks = _tokens(S, jcfg.vocab_size, 2, S)
    want = jtf.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got = steps.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(
        toks)})
    assert got.shape == (2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    hidden, _, _ = jtf.forward_hidden(jp, {"tokens": jnp.asarray(toks)},
                                      jcfg)
    got_h = transformer.forward_hidden(tp, {"tokens": torch.from_numpy(
        toks)}, tcfg)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(hidden), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_decode_steps_match_reference_over_a_wrapping_ring(name):
    """Twelve teacher-forced steps into an 8-slot cache (the ring wraps
    at step 8): logits and every layer's cache after each step."""
    jp, tp = _params(name)
    jcfg, tcfg = _small(name)
    B, steps_n, cap = 2, 12, 8
    toks = _tokens(3, jcfg.vocab_size, B, steps_n)
    jcache = jax.tree_util.tree_map(
        jnp.zeros_like, jparam.init_params(
            jtf.decode_cache_specs(jcfg, B, cap), jax.random.PRNGKey(1)))
    tcache = param.init_params(transformer.decode_cache_specs(tcfg, B, cap),
                               torch.Generator(), device="cpu")
    jstep = jax.jit(lambda p, b, c: j_decode_step(p, b, c, jcfg))
    tstep = steps.make_decode_step(tcfg)
    for t in range(steps_n):
        tok = toks[:, t:t + 1]
        want, jcache = jstep(jp, {"tokens": jnp.asarray(tok),
                                  "t": jnp.int32(t)}, jcache)
        got, tcache = tstep(tp, {"tokens": torch.from_numpy(tok), "t": t},
                            tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=f"step {t}")
        for j, c in zip(jax.tree_util.tree_leaves(jcache),
                        pt.leaves(tcache)):
            np.testing.assert_allclose(c.numpy(), np.asarray(j), atol=ATOL,
                                       err_msg=f"cache, step {t}")


def test_decode_matches_teacher_forcing():
    """Causal consistency in the port: decoding t tokens step by step
    reproduces the full-sequence forward's logits (dense arch)."""
    _, tp = _params("qwen")
    _, tcfg = _small("qwen")
    B, S = 1, 8
    toks = torch.from_numpy(_tokens(8, tcfg.vocab_size, B, S))
    hidden = transformer.forward_hidden(tp, {"tokens": toks}, tcfg)
    full = L.unembed(tp["embed"], hidden)
    cache = param.init_params(transformer.decode_cache_specs(tcfg, B, S),
                              torch.Generator(), device="cpu")
    outs = []
    for t in range(S):
        logits, cache = transformer.decode_step(
            tp, {"tokens": toks[:, t:t + 1], "t": t}, cache, tcfg)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=ATOL, rtol=RTOL)


def test_hybrid_decode_matches_teacher_forcing():
    """jamba's decode path (the mamba blocks' one-step recurrence on the
    cached state and conv window, the attention block's KV cache)
    reproduces the full-sequence forward's logits (the chunked scan) at
    every position, in the port.  S=8: a token takes an expert at most
    once, so no expert gets more than the capacity of 8 and the prefill
    drops no pair either."""
    _, tp = _params("jamba")
    _, tcfg = _small("jamba")
    B, S = 2, 8
    toks = torch.from_numpy(_tokens(9, tcfg.vocab_size, B, S))
    hidden = transformer.forward_hidden(tp, {"tokens": toks}, tcfg)
    full = L.head(tp["head"], hidden)
    cache = param.init_params(transformer.decode_cache_specs(tcfg, B, S),
                              torch.Generator(), device="cpu")
    outs = []
    for t in range(S):
        logits, cache = transformer.decode_step(
            tp, {"tokens": toks[:, t:t + 1], "t": t}, cache, tcfg)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _reference_serve(jp, jcfg, prompt, tokens, cache_len):
    """The reference's serve loop (``repro/launch/serve.py:39-58``)."""
    B, P = prompt.shape
    cache = jax.tree_util.tree_map(
        jnp.zeros_like, jparam.init_params(
            jtf.decode_cache_specs(jcfg, B, cache_len),
            jax.random.PRNGKey(0)))
    step = jax.jit(lambda p, b, c: j_decode_step(p, b, c, jcfg))
    for t in range(P):
        logits, cache = step(jp, {"tokens": prompt[:, t:t + 1],
                                  "t": jnp.int32(t)}, cache)
    out = []
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for t in range(P, P + tokens):
        logits, cache = step(jp, {"tokens": tok, "t": jnp.int32(t)}, cache)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(tok[:, 0])
    return np.asarray(jnp.stack(out, axis=1))


@pytest.mark.parametrize("name,cache_len", [("qwen", 128), ("yi-gqa", 8),
                                            ("qwen3-moe", 128),
                                            ("arctic", 8), ("jamba", 8)])
def test_generate_gives_the_reference_tokens(name, cache_len):
    """Greedy tokens of ``serve.generate`` on the reference's weights
    equal the reference's serve loop; at cache_len 8 the ring wraps."""
    jp, tp = _params(name)
    jcfg, tcfg = _small(name)
    prompt = _tokens(11, jcfg.vocab_size, 2, 6)
    want = _reference_serve(jp, jcfg, jnp.asarray(prompt), 6, cache_len)
    got = serve.generate(tp, tcfg, torch.from_numpy(prompt), 6, cache_len)
    assert got.tokens.shape == (2, 6)
    np.testing.assert_array_equal(got.tokens.numpy(), want)


def test_serve_main_runs_on_the_cpu(capsys):
    res = serve.main(["--device", "cpu", "--tokens", "3", "--prompt-len",
                      "4", "--arch", "yi-9b"])
    assert res.tokens.shape == (2, 3)
    assert "decoded 3 tokens x batch 2" in capsys.readouterr().out


def test_serve_main_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is moot")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--tokens", "1"])
