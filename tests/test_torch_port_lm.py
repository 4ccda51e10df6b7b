"""The port's Mamba language model against the JAX package's, on the CPU, at
tiny sizes (d_model 32-64, 2 layers, vocabulary 50, d_state 16; one test at
mamba-370m's d_model 1024, depth 1); inputs
from numpy seeds, weights from the JAX init converted by `lm_pairs`.

The port is held to the JAX **forward**, never to the JAX decoders' logits,
and where that forward is at fault, to the forward as corrected here: the
JAX `MixerModel` builds `norm_f` at flax's default eps 1e-6, while the
Blocks, both JAX decoders and the reference use 1e-5. The expected logits
are rebuilt from the JAX last Block's (h, residual), which
`capture_intermediates` gives, through `norm_f` at eps 1e-5 and the tied
head (`_expected_logits`). The JAX decoders are not used: they step with the
stored, shifted dt_proj weight and hard-code `LayerNorm_0` (ROADMAP.md,
queue 3).

Tolerances:
- `causal_conv1d_update`, `selective_state_update`: f32, max |port - jax|
  <= 1e-6 * (1 + max |jax|) (a 4-tap sum and one state update);
- `Block` and the whole model: f32, 2e-5 * (1 + max |jax|) (readings
  ~3e-7 relative: the scan and the projections sum in other orders);
- the decoders' step logits: within 1e-5 of the largest expected logit at
  every position (reading ~2e-7);
- every parameter gradient of (logits * w).sum(): f32, 1e-5 * (1 + max
  |jax|) (readings up to 6.5e-7: sums over tokens and channels in other
  orders);
- the JAX forward's own eps-1e-6 logits lie 1e-4 to 1e-2 of the largest
  logit from the corrected ones (reading ~3e-4), far outside the port's
  limit;
- the top-k and top-p filters, the greedy and sampled tokens, the eos stop
  and padding: exact.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.models import lm as jlm
from mm_unet_tpu.models.mamba import Block as JBlock
from mm_unet_tpu.ops.causal_conv1d import causal_conv1d_update as jax_conv_update
from mm_unet_tpu.ops.state_update import selective_state_update as jax_state_update
from mm_unet_tpu.utils.torch_convert import apply_pairs
from mm_unet_tpu_torch.models.lm import (
    MAMBA_130M,
    MAMBA_370M,
    MambaLMHeadModel,
    _top_k_filter,
    _top_p_filter,
    generate,
    generate_scan,
    give_lm,
    mamba_step,
)
from mm_unet_tpu_torch.models.mamba import Block
from mm_unet_tpu_torch.ops.causal_conv1d import causal_conv1d_update
from mm_unet_tpu_torch.ops.state_update import selective_state_update
from mm_unet_tpu_torch.utils.convert import jax_grads_to_torch, lm_pairs
from torch_port_harness import assert_close, load_torch, sub_pairs, to_numpy

N_LAYER, VOCAB, D_STATE = 2, 50, 16
STEP_TOL = 1e-6
MODEL_TOL = 2e-5
DECODE_TOL = 1e-5
GRAD_TOL = 1e-5
# (rms_norm, fused_add_norm): the JAX default and mamba-130m's setting
NORMS = [(False, False), (True, True)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("bias,activation", [(True, "silu"), (False, "silu"), (True, None)])
def test_causal_conv1d_update_matches_jax(bias, activation):
    rng = np.random.default_rng(1)
    x, state = rng.standard_normal((3, 24), np.float32), rng.standard_normal((3, 24, 4), np.float32)
    w = rng.standard_normal((24, 4), np.float32)
    b = rng.standard_normal(24).astype(np.float32) if bias else None
    want, want_state = jax_conv_update(jnp.asarray(x), jnp.asarray(state), jnp.asarray(w),
                                       None if b is None else jnp.asarray(b), activation)
    got, got_state = causal_conv1d_update(_t(x), _t(state), _t(w), None if b is None else _t(b),
                                          activation)
    assert_close(got.numpy(), want, STEP_TOL, "out")
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))


@pytest.mark.parametrize("full", [True, False])
def test_selective_state_update_matches_jax(full):
    """With D, z, dt_bias and softplus, and with none of them."""
    rng = np.random.default_rng(2)
    b, d, n = 3, 24, D_STATE
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    state, x, dt, B, C = f(b, d, n), f(b, d), f(b, d) * 0.5, f(b, n), f(b, n)
    A = -np.exp(f(d, n) * 0.5)
    extra = dict(D=f(d), z=f(b, d), dt_bias=f(d) * 0.1 - 2.0, dt_softplus=True) if full else {}
    want = jax_state_update(*map(jnp.asarray, (state, x, dt, A, B, C)),
                            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                               for k, v in extra.items()})
    got = selective_state_update(*map(_t, (state, x, dt, A, B, C)),
                                 **{k: _t(v) if isinstance(v, np.ndarray) else v
                                    for k, v in extra.items()})
    for g, w, what in zip(got, want, ("y", "state")):
        assert_close(g.numpy(), w, STEP_TOL, what)


@pytest.mark.parametrize("rms_norm", [False, True])
@pytest.mark.parametrize("fused_add_norm", [False, True])
@pytest.mark.parametrize("with_residual", [False, True])
def test_block_matches_jax(rms_norm, fused_add_norm, with_residual):
    """(hidden, residual) of one prenorm Block, the first (no residual yet)
    and a later one."""
    d = 32
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 10, d)).astype(np.float32)
    res = rng.standard_normal((2, 10, d)).astype(np.float32) if with_residual else None
    jm = JBlock(dim=d, rms_norm=rms_norm, fused_add_norm=fused_add_norm,
                mamba_kwargs={"d_state": D_STATE, "bimamba_type": "none"})
    args = (jnp.asarray(h), None if res is None else jnp.asarray(res))
    v = to_numpy(jm.init(jax.random.key(4), *args))
    # the port's norm keeps its random-free init (1, 0): perturb it
    norm = "RMSNorm_0" if rms_norm else "LayerNorm_0"
    v["params"][norm] = {k: (x + rng.normal(0, 0.2, x.shape)).astype(np.float32)
                         for k, x in v["params"][norm].items()}
    want_h, want_res = jm.apply(v, *args)
    pairs = sub_pairs(("backbone", "layers_0"), "backbone.layers.0.", lm_pairs(1, d, rms_norm))
    tm = load_torch(Block(d, rms_norm=rms_norm, fused_add_norm=fused_add_norm,
                          mamba_kwargs={"d_state": D_STATE}), v, pairs)
    with torch.no_grad():
        got_h, got_res = tm(_t(h), None if res is None else _t(res))
    assert_close(got_h.numpy(), want_h, MODEL_TOL, "hidden")
    assert_close(got_res.numpy(), want_res, MODEL_TOL, "residual")


def _jax_lm(rms_norm, fused_add_norm, d_model=64, seed=1, n_layer=N_LAYER):
    jm = jlm.MambaLMHeadModel(d_model=d_model, n_layer=n_layer, vocab_size=VOCAB,
                              d_state=D_STATE, rms_norm=rms_norm, fused_add_norm=fused_add_norm)
    v = to_numpy(jm.init(jax.random.key(seed), jnp.zeros((1, 4), jnp.int32)))
    # perturb every norm away from its init (1, 0), so that the norms' weights
    # and eps are exercised
    rng = np.random.default_rng(seed + 100)
    bb = v["params"]["backbone"]
    for name, node in bb.items():
        for key in ("LayerNorm_0", "RMSNorm_0"):
            if key in node:
                node[key] = {k: (x + rng.normal(0, 0.2, x.shape)).astype(np.float32)
                             for k, x in node[key].items()}
    bb["norm_f"] = {k: (x + rng.normal(0, 0.2, x.shape)).astype(np.float32)
                    for k, x in bb["norm_f"].items()}
    tm = load_torch(MambaLMHeadModel(d_model, n_layer, VOCAB, D_STATE, rms_norm, fused_add_norm),
                    v, lm_pairs(n_layer, d_model, rms_norm))
    return jm, v, tm


def _expected_logits(jm, v, ids, rms_norm):
    """(the JAX forward's logits corrected to norm_f's eps 1e-5, the JAX
    forward's own logits): the last Block's (h, residual), added, through
    norm_f at eps 1e-5 and the tied head, in float64."""
    out, state = jm.apply(v, jnp.asarray(ids), capture_intermediates=True,
                          mutable=["intermediates"])
    h, res = state["intermediates"]["backbone"][f"layers_{jm.n_layer - 1}"]["__call__"][0]
    x = np.asarray(h, np.float64) + np.asarray(res, np.float64)
    p = v["params"]["backbone"]["norm_f"]
    if rms_norm:
        y = x / np.sqrt(np.square(x).mean(-1, keepdims=True) + 1e-5) * p["scale"]
    else:
        y = (x - x.mean(-1, keepdims=True)) / np.sqrt(x.var(-1, keepdims=True) + 1e-5)
        y = y * p["scale"] + p["bias"]
    return y @ v["params"]["backbone"]["embedding"]["embedding"].T.astype(np.float64), np.asarray(out)


@pytest.mark.parametrize("rms_norm,fused_add_norm", NORMS)
def test_lm_forward_matches_jax(rms_norm, fused_add_norm):
    """The port's logits against the corrected JAX forward; and how far the
    JAX forward's own eps-1e-6 norm_f puts it from the same logits."""
    jm, v, tm = _jax_lm(rms_norm, fused_add_norm)
    ids = np.random.default_rng(5).integers(0, VOCAB, (2, 12))
    want, jax_out = _expected_logits(jm, v, ids, rms_norm)
    with torch.no_grad():
        got = tm(_t(ids)).numpy()
    assert got.shape == (2, 12, VOCAB)
    assert_close(got, want, MODEL_TOL, "logits")
    top = np.abs(want).max()
    jax_off = np.abs(jax_out - want).max() / top
    assert 1e-4 <= jax_off <= 1e-2, jax_off


@pytest.mark.parametrize("rms_norm,fused_add_norm", NORMS)
@pytest.mark.parametrize("decoder", [generate, generate_scan])
def test_teacher_forced_step_logits_match_the_forward(decoder, rms_norm, fused_add_norm):
    """Teacher-forced decoding through the whole sequence: the tokens are
    the teacher's, and the logits after every consumed token equal the
    corrected JAX forward's at that position."""
    jm, v, tm = _jax_lm(rms_norm, fused_add_norm)
    ids = np.random.default_rng(6).integers(0, VOCAB, (2, 11))
    want, _ = _expected_logits(jm, v, ids, rms_norm)
    tokens, logits = decoder(tm, _t(ids[:, :4]), 7, teacher_outputs=_t(ids), return_logits=True)
    np.testing.assert_array_equal(tokens.numpy(), ids)
    assert logits.shape == (2, 11, VOCAB)
    err = np.abs(logits.numpy() - want).max()
    assert err <= DECODE_TOL * np.abs(want).max(), err


@pytest.mark.parametrize("rms_norm,fused_add_norm", NORMS)
def test_greedy_tokens_are_the_forward_argmax(rms_norm, fused_add_norm):
    """Each greedy token is the argmax of the corrected JAX forward's
    logits at the position before it (the runner-up trails by more than the
    decode tolerance, so the argmax is sound), for both decoders."""
    jm, v, tm = _jax_lm(rms_norm, fused_add_norm)
    prompt = np.random.default_rng(7).integers(0, VOCAB, (2, 4))
    tokens = generate(tm, _t(prompt), 6).numpy()
    np.testing.assert_array_equal(generate_scan(tm, _t(prompt), 6).numpy(), tokens)
    want, _ = _expected_logits(jm, v, tokens, rms_norm)
    top2 = np.sort(want[:, 3:-1], -1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > DECODE_TOL * np.abs(want).max()
    np.testing.assert_array_equal(tokens[:, 4:], want[:, 3:-1].argmax(-1))


def _check_lm_gradients(rms_norm, fused_add_norm, d_model, n_layer, ids, rng):
    """Every parameter gradient of (logits * w).sum(): autograd of the port
    against `jax.grad` of the JAX model with its norm_f corrected to eps
    1e-5 (the last Block's (h, residual) from `capture_intermediates`,
    through norm_f and the tied head in the loss), its gradients carried to
    the port's names by `lm_pairs`. Returns (the port's model, the corrected
    JAX logits of that pass, f32)."""
    jm, v, tm = _jax_lm(rms_norm, fused_add_norm, d_model=d_model, n_layer=n_layer)
    w = rng.standard_normal((*ids.shape, VOCAB)).astype(np.float32)

    def loss(params):
        _, state = jm.apply({**v, "params": params}, jnp.asarray(ids),
                            capture_intermediates=True, mutable=["intermediates"])
        h, res = state["intermediates"]["backbone"][f"layers_{n_layer - 1}"]["__call__"][0]
        x, p = h + res, params["backbone"]["norm_f"]
        if rms_norm:
            y = x / jnp.sqrt(jnp.mean(x * x, -1, keepdims=True) + 1e-5) * p["scale"]
        else:
            mu = x.mean(-1, keepdims=True)
            y = (x - mu) / jnp.sqrt(((x - mu) ** 2).mean(-1, keepdims=True) + 1e-5)
            y = y * p["scale"] + p["bias"]
        logits = y @ params["backbone"]["embedding"]["embedding"].T
        return jnp.sum(logits * w), logits

    (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(v["params"])
    want = jax_grads_to_torch(to_numpy(grads), lm_pairs(n_layer, d_model, rms_norm))
    tm.train()
    (tm(_t(ids)) * _t(w)).sum().backward()
    got = dict(tm.named_parameters())
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        assert_close(got[name].grad.numpy(), g.numpy(), GRAD_TOL, name)
    return tm, np.asarray(logits)


@pytest.mark.parametrize("rms_norm,fused_add_norm", NORMS)
def test_lm_gradients_match_jax(rms_norm, fused_add_norm):
    """Every parameter gradient (`_check_lm_gradients`) at d_model 32, 2
    layers, 2 x 64 tokens."""
    rng = np.random.default_rng(13)
    ids = rng.integers(0, VOCAB, (2, 64))
    _check_lm_gradients(rms_norm, fused_add_norm, 32, N_LAYER, ids, rng)


def test_lm_at_mamba_370m_width_matches_jax():
    """mamba-370m's widths and norms (`MAMBA_370M`: d_model 1024, so
    d_inner 2048, dt_rank 64, x_dbl rows 96; RMSNorm with fused add+norm)
    at depth 1, vocabulary 50 (the head never reaches the kernels) and 1 x
    48 tokens: every parameter gradient (`_check_lm_gradients`, GRAD_TOL)
    and the logits against the corrected JAX forward of that pass
    (MODEL_TOL)."""
    assert MAMBA_370M["d_model"] == 1024 and MAMBA_370M["rms_norm"]
    assert MAMBA_370M["fused_add_norm"]
    rng = np.random.default_rng(370)
    ids = rng.integers(0, VOCAB, (1, 48))
    tm, want = _check_lm_gradients(True, True, MAMBA_370M["d_model"], 1, ids, rng)
    mixer = tm.backbone.layers[0].mixer
    assert (mixer.d_inner, mixer.dt_rank, mixer.d_state) == (2048, 64, 16)
    with torch.no_grad():
        got = tm(_t(ids)).numpy()
    assert_close(got, want, MODEL_TOL, "logits")


def test_sampled_decoders_agree_token_for_token():
    """Top-k then top-p sampling from one generator seed: both decoders draw
    in the same order and emit the same tokens, teacher-forced steps in
    between drawing nothing."""
    _, _, tm = _jax_lm(True, True)
    prompt = _t(np.random.default_rng(8).integers(0, VOCAB, (2, 4)))
    teacher = torch.cat([prompt, _t(np.random.default_rng(9).integers(0, VOCAB, (2, 2)))], 1)
    kw = dict(temperature=0.8, top_k=5, top_p=0.9)
    for forced in (None, teacher):
        runs = [dec(tm, prompt, 8, generator=torch.Generator().manual_seed(11),
                    teacher_outputs=forced, **kw) for dec in (generate, generate_scan)]
        np.testing.assert_array_equal(runs[0].numpy(), runs[1].numpy())
    other = generate(tm, prompt, 8, generator=torch.Generator().manual_seed(12), **kw)
    assert not torch.equal(other, runs[0])


def test_filters_match_jax_exactly():
    """The top-k mask (as the JAX decoders write it) and `_top_p_filter`,
    on the same logits, element for element."""
    lg = np.random.default_rng(10).standard_normal((4, VOCAB)).astype(np.float32) * 3
    kth = jax.lax.top_k(jnp.asarray(lg), 5)[0][:, -1:]
    want_k = np.asarray(jnp.where(jnp.asarray(lg) < kth, -jnp.inf, jnp.asarray(lg)))
    np.testing.assert_array_equal(_top_k_filter(_t(lg), 5).numpy(), want_k)
    for top_p in (0.3, 0.9, 1.0):
        want_p = np.asarray(jlm._top_p_filter(jnp.asarray(lg), top_p))
        np.testing.assert_array_equal(_top_p_filter(_t(lg), top_p).numpy(), want_p)


def test_teacher_forcing_and_eos():
    """`tests/test_lm.py`'s cases: the teacher's tokens replace the decoded
    ones at in-range positions; a forced all-eos column stops `generate`
    there (the eos column included), and `generate_scan` pads the rest of
    its fixed shape with eos."""
    _, _, tm = _jax_lm(False, False)
    prompt = _t(np.random.default_rng(11).integers(0, VOCAB, (2, 4)))
    teacher = _t(np.random.default_rng(12).integers(1, VOCAB, (2, 7)))
    a = generate(tm, prompt, 6, teacher_outputs=teacher)
    np.testing.assert_array_equal(a[:, 4:7].numpy(), teacher[:, 4:7].numpy())
    np.testing.assert_array_equal(generate_scan(tm, prompt, 6, teacher_outputs=teacher).numpy(),
                                  a.numpy())
    eos = 5
    teacher_eos = teacher.clone()
    teacher_eos[:, 5] = eos
    a = generate(tm, prompt, 6, teacher_outputs=teacher_eos, eos_token_id=eos)
    assert a.shape[1] == 6 and bool((a[:, -1] == eos).all())
    b = generate_scan(tm, prompt, 6, teacher_outputs=teacher_eos, eos_token_id=eos)
    assert b.shape[1] == 10
    np.testing.assert_array_equal(a.numpy(), b[:, :6].numpy())
    assert bool((b[:, 6:] == eos).all())


def test_mamba_step_reads_the_unshifted_dt_weight():
    """One token from zero caches through `mamba_step` equals the Block's
    mixer forward on a one-token sequence: the step computes what the
    forward computes (the JAX `mamba_step` multiplies the stored, shifted
    weight)."""
    _, _, tm = _jax_lm(False, False, d_model=32)
    mixer = tm.backbone.layers[0].mixer
    x = _t(np.random.default_rng(13).standard_normal((3, 32)).astype(np.float32))
    conv = torch.zeros(3, mixer.d_inner, 4)
    ssm = torch.zeros(3, mixer.d_inner, D_STATE)
    with torch.no_grad():
        y, conv2, _ = mamba_step(mixer, x, conv, ssm)
        want = mixer(x[:, None])[:, 0]
    assert_close(y.numpy(), want.numpy(), MODEL_TOL, "step")
    assert torch.equal(conv2[..., :-1], conv[..., 1:])


@pytest.mark.parametrize("rms_norm", [False, True])
def test_lm_pairs_strict_round_trip(rms_norm):
    """JAX variables -> the port's state_dict (every leaf used, the keys and
    shapes exactly the model's) -> back through the JAX package's
    `apply_pairs` (strict): every leaf returns, dt_proj's shift to rounding."""
    jm, v, tm = _jax_lm(rms_norm, rms_norm, d_model=32)
    pairs = lm_pairs(N_LAYER, 32, rms_norm)
    sd = {k: t.numpy() for k, t in tm.state_dict().items()}
    back = apply_pairs(jax.tree_util.tree_map(np.zeros_like, v), sd, pairs, strict=True)
    flat = jax.tree_util.tree_leaves_with_path(v)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got) == len(pairs)
    for path, want in flat:
        if "dt_proj" in jax.tree_util.keystr(path):
            np.testing.assert_allclose(got[path], want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[path], want)


def test_give_lm_widths_and_device(monkeypatch):
    """mamba-130m's config pads its vocabulary 50277 to 50280; the entry
    point runs on the card unless the caller asks for the CPU; each forward
    launches one fused scan per Block."""
    cfg = dict(MAMBA_130M, d_model=32, n_layer=2, vocab_size=50)
    tm = give_lm(cfg, device="cpu")
    assert tm.vocab_size == 56 and tm.rms_norm and tm.fused_add_norm and tm.d_state == 16
    assert tm.kernel_launches_per_forward() == {"mamba_fused_scan": 2}
    assert -(-MAMBA_130M["vocab_size"] // 8) * 8 == 50280
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        give_lm(cfg)


def test_lm_modules_never_import_jax():
    code = (
        "import sys\n"
        "import mm_unet_tpu_torch.models.lm, mm_unet_tpu_torch.ops.state_update\n"
        "import mm_unet_tpu_torch.utils.convert, mm_unet_tpu_torch.train.loop\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'mm_unet_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
