"""The port's training half against the reference's: the flash-attention
backward's plain version, attention and loss gradients, AdamW, one train
step with gradient accumulation, ``microbatch_reshape`` and the training
CLI, on the CPU with the reference's initial state carried across
(``convert.train_state_from_numpy``).  The backward kernel itself runs only
on the card (``cuda`` marker).

Tolerances, each stated at its test: the backward's plain version against
``jax.vjp`` of the reference's oracle 1e-5 (f32; both sum in f32 in other
orders) and 2e-2 (bf16: one bf16 ulp of gradients up to 2, as
``BF16_ATTN_TOL``), each relative and absolute against the larger of 1 and
the gradient's largest magnitude, ``tests/test_torch_models.py``'s form;
attention gradients 1e-4 in the same form (the chunked loop's f32 sums in
another order than XLA's); the loss 1e-5 and each gradient leaf 1e-4
relative in norm (``|g - w| <= 1e-4 |w| + 1e-7 sqrt(n)``, 2-norms) in f32,
and in bf16 2e-2 elementwise, relative and against the leaf's scale, held
against the reference run op by op (``jax.disable_jit``, which rounds where
the port rounds; under ``jit`` XLA's fusions skip bf16 roundings).  The
random smoke model is ill-conditioned: a 1e-7 relative perturbation of its
float32 weights moves its own gradients by up to 1.1e-4 of a leaf's largest
element, so an elementwise 1e-4 bound cannot separate the packages from
rounding; the norm-wise bound does (measured 8.2e-5 at worst).  AdamW
1e-6 relative (the same f32 formula; XLA and torch round ``cos`` and
``pow`` apart in the last bit); the train step's loss and ``grad_norm``
1e-5, moments at the gradient tolerance, parameters and master within
2 lr(1) = 6e-6 absolute (a sign flip of a near-zero gradient element moves
an element by at most that at ``OptConfig(total_steps=10)``).
"""
import dataclasses
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels import ref as jref
from repro.models import layers as RL
from repro.models import lm as rlm
from repro.models.params import init_params as ref_init_params
from repro.optim import adamw as radamw
from repro.train import step as rstep
from repro_torch.configs import get_config
from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (BWD_NAME, BWD_TC_COUNTER, bwd_plan,
                                                 flash_attention, flash_attention_bwd,
                                                 flash_attention_train)
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models.params import ParamTree, leaves, tree_leaves, tree_unflatten
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.guards import LAUNCH_COUNTS
from repro_torch.train import step as tstep

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BWD_REF_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ATTN_GRAD_TOL = 1e-4
LOSS_TOL_F32, GRAD_RTOL_F32, GRAD_ATOL_F32 = 1e-5, 1e-4, 1e-7  # loss; gradients in norm
BF16_TOL = 2e-2
ADAMW_RTOL = 1e-6
STEP_PARAM_ATOL = 6e-6  # 2 * lr(1) at OptConfig(total_steps=10)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _close_to_scale(got, want, tol: float, what: str = ""):
    """|got - want| <= tol * (|want| + max(1, max |want|)) elementwise, in
    f32: ``tests/test_torch_models.py``'s form of a tolerance (an element
    summed from terms of the tensor's scale carries their rounding)."""
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


# ---------------------------------------------------------------------------
# The flash-attention backward: plain version and autograd function (CPU)
# ---------------------------------------------------------------------------


def _jax_vjp(q, k, v, do, causal, window):
    """(dq, dk, dv) by ``jax.vjp`` of the reference's oracle, which takes
    Hkv == H: grouped kv heads are repeated, and vjp sums their gradients."""
    group = q.shape[1] // k.shape[1]

    def f(q, k, v):
        return jref.flash_attention_ref(q, jnp.repeat(k, group, axis=1),
                                        jnp.repeat(v, group, axis=1), causal=causal,
                                        window=window)

    _, vjp = jax.vjp(f, q, k, v)
    return vjp(do)


# The forward's test grid (tests/test_kernels.py), and grouped heads with S < T.
BWD_GRID = ([(2, 3, 3, s, t, 64, causal, window)
             for s, t in ((64, 64), (96, 96), (1, 96))
             for causal, window in ((True, 0), (True, 32), (False, 0))]
            + [(2, 6, 2, 9, 21, 16, True, 0), (2, 6, 2, 9, 21, 16, True, 5),
               (1, 8, 2, 13, 13, 16, False, 4)])


# (B, S, T, Hq, Hkv, D, causal, window): tests/test_torch_models.py's kernel
# cases (MHA and GQA, widths 64, 128, 168 and 256, ragged tiles, S < T).
BWD_KERNEL_CASES = [
    (2, 64, 64, 3, 3, 64, True, 0),
    (2, 96, 96, 3, 3, 64, True, 32),
    (2, 1, 96, 3, 3, 64, True, 0),
    (2, 96, 96, 3, 3, 64, False, 0),
    (1, 130, 200, 8, 2, 128, True, 0),
    (1, 77, 77, 4, 1, 168, True, 24),
    (3, 40, 65, 6, 3, 12, False, 17),
    (1, 300, 300, 4, 4, 256, True, 70),
    (1, 260, 260, 48, 8, 128, True, 0),
]
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # chip_smoke.FLASH_TOL


@pytest.mark.parametrize("case", BWD_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_ref_matches_jax_vjp(case, dtype):
    """``ref.flash_attention_bwd_ref`` against ``jax.vjp`` of
    ``repro.kernels.ref.flash_attention_ref``: causal, non-causal, window,
    S < T and grouped kv heads.  Tolerance 1e-5 (f32), 2e-2 (bf16)."""
    b, h, hkv, s, t, d, causal, window = case
    rng = np.random.default_rng(sum(case) + len(dtype))
    (jq, q), (jk, k), (jv, v), (jdo, do) = (
        _pair(rng.standard_normal(shape), dtype)
        for shape in ((b, h, s, d), (b, hkv, t, d), (b, hkv, t, d), (b, h, s, d)))
    o = ref.flash_attention_ref(q, k, v, causal, window)
    got = ref.flash_attention_bwd_ref(q, k, v, o, do, causal, window)
    want = _jax_vjp(jq, jk, jv, jdo, causal, window)
    tol = BWD_REF_TOL[dtype]
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        _close_to_scale(g, w, tol, name)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3), (False, 0)])
def test_flash_attention_lse_matches_logsumexp(causal, window):
    """The forward's ``return_lse`` on the CPU: each row's log-sum-exp of its
    scaled, masked logits, as ``jax.nn.logsumexp`` gives it (f32, 1e-6)."""
    rng = np.random.default_rng(11)
    q, k = (rng.standard_normal((2, 4, n, 8)).astype(np.float32) for n in (5, 7))
    out, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
                               causal=causal, window=window, return_lse=True)
    assert lse.shape == (2, 4, 5) and lse.dtype == torch.float32
    logits = np.einsum("bhsd,bhtd->bhst", q, k) / np.sqrt(8.0)
    qpos, kpos = np.arange(5)[:, None] + 2, np.arange(7)[None, :]
    mask = np.ones((5, 7), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    want = jax.nn.logsumexp(jnp.where(mask, logits, -1e30), axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_flash_attention_train_on_the_cpu_is_the_plain_gradient():
    """The autograd function on CPU tensors (its wrappers take the plain
    versions) gives the chunked loop's gradients, in the (B, S, H, D) layout
    ``gqa_chunked`` hands it; the backward counts no kernel launch."""
    rng = np.random.default_rng(2)
    b, s, t, hq, hkv, d = 2, 6, 10, 4, 2, 8
    x = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_()
         for shape in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d))]
    do = torch.from_numpy(rng.standard_normal((b, s, hq, d)).astype(np.float32))
    before = LAUNCH_COUNTS[BWD_NAME]
    out = flash_attention_train(*x, causal=True, window=4, layout="bshd")
    got = torch.autograd.grad(out, x, do)
    y = [t_.detach().requires_grad_() for t_ in x]
    plain = TL.gqa_chunked_plain(*y, causal=True, window=4, chunk=4)
    want = torch.autograd.grad(plain, y, do)
    assert LAUNCH_COUNTS[BWD_NAME] == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    o, lse = flash_attention(*(t_.detach() for t_ in x), causal=True, window=4, layout="bshd",
                             return_lse=True)
    again = flash_attention_bwd(*(t_.detach() for t_ in x), o, do, lse, causal=True, window=4,
                                layout="bshd")
    for g, w in zip(again, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError):
        flash_attention_bwd(*(t_.detach() for t_ in x), o, do, lse[:, :1], layout="bshd")


def _tc_bwd_emulation(q, k, v, o, do, lse, causal, window):
    """The bf16 tensor-core backward's arithmetic in plain torch, tile by tile
    (``csrc/flash_attention_bwd.cu``, ``bwd_prep_tc``, ``bwd_dkdv_tc``,
    ``bwd_dq_tc``): bf16 operands, f32 products and accumulators; D =
    rowsum(dO o O) in f32; P^T = exp2(S^T scale_log2 - lse log2(e)) from the
    f32 scores, in the log2 domain, zero where masked; dS^T = P^T o (dP^T -
    D) from the f32 P^T; P^T and dS^T rounded to bf16 before dV += P^T dO and
    dK += dS^T Q, which sum over the group's query heads in turn and the q
    tiles ascending (``bwd_plan``'s q rows a stage); dQ += dS K over the k
    tiles ascending, dS rounded to bf16; the scale applied to the f32 dK and
    dQ, then bf16.  (B, H, S, D) q, o, do; (B, Hkv, T, D) k, v; lse (B, H,
    S).  Sums inside a tile run in another order than the tensor cores', and
    exp2 keeps results below 2^-126 that the kernel flushes."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    group = h // hkv
    plan = bwd_plan(d)
    scale = np.float32(1.0 / math.sqrt(d))  # the wrapper's c_float
    scale_log2 = torch.tensor(np.float32(float(scale) * math.log2(math.e)))
    lse2 = lse.float() * torch.tensor(np.float32(math.log2(math.e)))
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    delta = (dof * of).sum(-1)
    pos = torch.arange(s) + (t - s)
    keys = torch.arange(t)
    live = torch.ones((s, t), dtype=torch.bool)
    if causal:
        live &= keys[None, :] <= pos[:, None]
    if window > 0:
        live &= keys[None, :] > pos[:, None] - window
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731

    dk = torch.zeros((b, hkv, t, d))
    dv = torch.zeros((b, hkv, t, d))
    for g in range(group):
        heads = torch.arange(hkv) * group + g
        for q0 in range(0, s, plan.q_rows):
            rows = slice(q0, q0 + plan.q_rows)
            qt, dot = qf[:, heads, rows], dof[:, heads, rows]
            st = torch.einsum("bhtd,bhsd->bhts", kf, qt) * scale_log2
            pt = torch.exp2(st - lse2[:, heads, None, rows])
            pt = torch.where(live[rows].T, pt, torch.zeros(()))
            dpt = torch.einsum("bhtd,bhsd->bhts", vf, dot)
            dst = pt * (dpt - delta[:, heads, None, rows])
            dv += torch.einsum("bhts,bhsd->bhtd", bf(pt), dot)
            dk += torch.einsum("bhts,bhsd->bhtd", bf(dst), qt)

    kx, vx = kf.repeat_interleave(group, 1), vf.repeat_interleave(group, 1)
    dq = torch.zeros((b, h, s, d))
    for k0 in range(0, t, plan.dq_k_rows):
        cols = slice(k0, k0 + plan.dq_k_rows)
        sc = torch.einsum("bhsd,bhtd->bhst", qf, kx[:, :, cols]) * scale_log2
        p = torch.where(live[:, cols], torch.exp2(sc - lse2[..., None]), torch.zeros(()))
        dp = torch.einsum("bhsd,bhtd->bhst", dof, vx[:, :, cols])
        dq += torch.einsum("bhst,bhtd->bhsd", bf(p * (dp - delta[..., None])), kx[:, :, cols])
    out = (dq * scale, dk * scale, dv)
    return tuple(x.to(torch.bfloat16) for x in out)


@pytest.mark.parametrize("case", BWD_GRID)
def test_flash_attention_bwd_tc_rounding_within_bf16_tolerance(case):
    """At the plain version's grid, the rounding the tensor-core backward adds
    (P^T and dS^T in bf16 before their products, exp2 of the f32 scores in
    the log2 domain) stays within BWD_REF_TOL (bf16) of ``jax.vjp`` of the
    reference's oracle."""
    b, h, hkv, s, t, d, causal, window = case
    rng = np.random.default_rng(sum(case) + 17)
    (jq, q), (jk, k), (jv, v), (jdo, do) = (
        _pair(rng.standard_normal(shape), "bfloat16")
        for shape in ((b, h, s, d), (b, hkv, t, d), (b, hkv, t, d), (b, h, s, d)))
    o, lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    got = _tc_bwd_emulation(q, k, v, o, do, lse, causal, window)
    want = _jax_vjp(jq, jk, jv, jdo, causal, window)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        _close_to_scale(g, w, BWD_REF_TOL["bfloat16"], name)


@pytest.mark.parametrize("case", BWD_KERNEL_CASES)
def test_flash_attention_bwd_tc_rounding_at_the_kernel_cases(case):
    """The same emulation at the ``cuda`` tests' shapes (widths 12-256, GQA,
    S < T, windows, ragged tiles, two passes above width 128) against the
    port's plain version, within the kernel tests' KERNEL_TOL (bf16)."""
    b, s, t, hq, hkv, d, causal, window = case
    gen = torch.Generator().manual_seed(s * 17 + t)
    q, do = (torch.randn((b, hq, s, d), generator=gen).bfloat16() for _ in "qd")
    k, v = (torch.randn((b, hkv, t, d), generator=gen).bfloat16() for _ in "kv")
    o, lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    got = _tc_bwd_emulation(q, k, v, o, do, lse, causal, window)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal, window)
    tol = KERNEL_TOL[torch.bfloat16]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


SMEM_BYTES = 232_448  # an H100 block's dynamic shared memory


@pytest.mark.parametrize("d,want", [
    (1, (64, 64, 1, 128)), (12, (64, 64, 1, 128)), (64, (64, 64, 1, 128)),
    (65, (128, 64, 1, 64)), (128, (128, 64, 1, 64)), (168, (192, 64, 2, 64)),
    (192, (192, 64, 2, 64)), (200, (256, 32, 2, 32)), (256, (256, 32, 2, 32)),
])
def test_flash_attention_bwd_plan(d, want):
    """The bf16 backward's plan (width, q rows a stage, passes, dQ's k rows a
    stage): both kernels' tiles (K and V of 128 keys with a ring of Q and
    dO; Q and dO of 128 rows with a ring of K and V) fit a block's shared
    memory; two passes, and so 8 products, only above width 128."""
    plan = bwd_plan(d)
    assert (plan.width, plan.q_rows, plan.passes, plan.dq_k_rows) == want
    assert plan.kv_rows == plan.dq_rows == plan.row_pad == 128 and plan.stages == 2
    ring, item = plan.stages, 2
    dkdv = (item * plan.width * (2 * plan.kv_rows + ring * 2 * plan.q_rows)
            + ring * 2 * 4 * plan.q_rows)
    dq = (item * plan.width * (2 * plan.dq_rows + ring * 2 * plan.dq_k_rows)
          + 2 * 4 * plan.dq_rows)
    barriers = 8 * (1 + 2 * ring)
    assert max(dkdv, dq) + barriers + 1024 <= SMEM_BYTES


@pytest.mark.parametrize("arch,window", [("stablelm-1.6b", 0), ("internlm2-20b", 5)])
def test_attention_train_grads_match_reference(arch, window):
    """Gradients of ``attention_train`` (w.r.t. the input and every attention
    parameter) against ``jax.grad`` of the reference's, f32, MHA and GQA with
    a window.  Tolerance 1e-4."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype="float32")
    jp = ref_init_params(jax.random.PRNGKey(6), RL.attn_params(rcfg), jnp.float32)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)

    def rloss(p, xx):
        return jnp.sum(RL.attention_train(p, rcfg, xx, window=window) * dy)

    want_p, want_x = jax.jit(jax.grad(rloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = {"/".join(path): torch.from_numpy(np.array(v)).requires_grad_()
          for path, v in leaves(jp)}
    tx = torch.from_numpy(x).requires_grad_()
    tree = {k: v for k, v in tp.items()}
    tree["ln"] = {"scale": tree.pop("ln/scale")}
    y = TL.attention_train(tree, cfg, tx, window=window)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), [tx, *tp.values()])
    _close_to_scale(grads[0], want_x, ATTN_GRAD_TOL, "x")
    for (name, _), g in zip(tp.items(), grads[1:]):
        node = want_p
        for k in name.split("/"):
            node = node[k]
        _close_to_scale(g, node, ATTN_GRAD_TOL, name)


# ---------------------------------------------------------------------------
# loss_fn, AdamW, the train step
# ---------------------------------------------------------------------------

_REF_STATES = {}


def _close_in_norm(got, want, rtol: float, atol: float, what: str = ""):
    """2-norm |got - want| <= rtol |want| + atol sqrt(n), in f32."""
    got, want = _f32(got), _f32(want)
    err, scale = float(np.linalg.norm(got - want)), float(np.linalg.norm(want))
    assert err <= rtol * scale + atol * np.sqrt(want.size), (
        f"{what}: |diff| {err:.3e} against |want| {scale:.3e} (rtol {rtol}, atol {atol})")


def _states(arch: str, dtype: str, total_steps: int = 10, **cfg_kw):
    """(reference cfg, spec, state; port cfg, spec, state): the reference's
    ``init_train_state`` (jit-compiled once per key) carried across bit for
    bit."""
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype, **cfg_kw)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype, **cfg_kw)
    rspec = rstep.TrainSpec(microbatch=2, opt=radamw.OptConfig(total_steps=total_steps))
    spec = tstep.TrainSpec(microbatch=2, opt=tadamw.OptConfig(total_steps=total_steps))
    key = (arch, dtype, total_steps, tuple(sorted(cfg_kw.items())))
    if key not in _REF_STATES:
        _REF_STATES[key] = jax.jit(lambda k: rstep.init_train_state(k, rcfg, rspec))(
            jax.random.PRNGKey(1))
    rstate = _REF_STATES[key]
    state = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, rstate), cfg, spec,
                                   device="cpu")
    return rcfg, rspec, rstate, cfg, spec, state


def _tokens(cfg, b: int, s: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _port_grads(cfg, params, tokens):
    flat = [x.detach().requires_grad_() for x in tree_leaves(params)]
    loss = tlm.loss_fn(tree_unflatten(params, flat, dicts=True), cfg,
                       {"tokens": torch.from_numpy(tokens)})
    return loss, torch.autograd.grad(loss, flat)


# The configs whose bf16 gradients are held per leaf in norm against the
# reference's own bf16 error (the MoE configs of attention blocks).
MOE_NORM_ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b")


@pytest.mark.parametrize("arch,dtype,cfg_kw", [
    pytest.param("stablelm-1.6b", "float32", {}, id="float32-cfg_kw0"),
    pytest.param("stablelm-1.6b", "bfloat16", {}, id="bfloat16-cfg_kw1"),
    pytest.param("stablelm-1.6b", "float32", {"padded_vocab": 320}, id="float32-cfg_kw2"),
    pytest.param("qwen1.5-32b", "bfloat16", {}, id="qwen1.5-bfloat16"),
    pytest.param("qwen2-moe-a2.7b", "float32", {}, id="qwen2-moe-float32"),
    pytest.param("qwen2-moe-a2.7b", "bfloat16", {}, id="qwen2-moe-bfloat16"),
    pytest.param("qwen3-moe-30b-a3b", "float32", {}, id="qwen3-moe-float32"),
    pytest.param("qwen3-moe-30b-a3b", "bfloat16", {}, id="qwen3-moe-bfloat16"),
    pytest.param("qwen2-moe-a2.7b", "float32", {"capacity_factor": 0.5},
                 id="qwen2-moe-float32-drops"),
    pytest.param("xlstm-350m", "float32", {}, id="xlstm-float32"),
    pytest.param("xlstm-350m", "bfloat16", {}, id="xlstm-bfloat16"),
    pytest.param("jamba-1.5-large-398b", "float32", {}, id="jamba-float32"),
    pytest.param("jamba-1.5-large-398b", "bfloat16", {}, id="jamba-bfloat16"),
])
def test_loss_fn_and_grads_match_reference(arch, dtype, cfg_kw):
    """``loss_fn`` and its gradients against
    ``jax.value_and_grad(repro.models.lm.loss_fn)`` on the stablelm-1.6b
    smoke config, qwen1.5-32b's in bf16 (qkv biases, padded heads, a width
    of 60 whose sqrt is rounded to bf16 before it scales the embedding) and
    the two MoE smoke configs (``xent + 0.01 aux``; the
    router's and the experts' gradients among the leaves): f32 (and with the
    vocab padded, whose logits are -1e30; and qwen2-moe at a capacity factor
    that drops picks) loss 1e-5 and each leaf 1e-4 relative in norm (atol
    1e-7 an element); bf16 against the reference run op by op: the loss
    2e-2, each leaf elementwise 2e-2 for the dense configs, and for the MoE configs
    each leaf in norm within a quarter of the reference's own bf16 error
    (``|g - w| <= |w - w32| / 4``, ``w32`` the reference's f32 gradient at
    the same weights).  Their random smoke models amplify the attention's
    one-ulp bf16 differences (layer 0's output differs from the reference's
    in one element by one ulp; no pick differs) into one element of
    qwen2-moe's ``bk`` gradient 3.9e-2 off elementwise and 2.1e-2 in norm,
    where the reference's bf16 gradients are 10-22% in norm from its f32
    ones (the port's at most a tenth of that).  The MoE layer's own
    gradients are held elementwise on the same input in
    ``tests/test_torch_moe.py``.  The recurrent smoke configs: xlstm-350m
    (mLSTM and sLSTM) and jamba-1.5-large-398b (mamba beside attention and
    MoE) at the same bounds, jamba's bf16 leaves elementwise like the dense
    configs': behind each mamba layer's convolution its gradients equal the
    reference's bit for bit, and the convolution's weights' gradient, which
    the reference sums over the positions in bf16 one row at a time where
    torch sums in float32, is as close to the f32 gradient as the
    reference's.  Sequence 40 with loss and
    attention chunks of 16: a padded last chunk and three kv chunks."""
    rcfg, _, rstate, cfg, _, state = _states(arch, dtype, **cfg_kw)
    tokens = _tokens(cfg, 2, 40)
    value_and_grad = jax.value_and_grad(lambda p, t: rlm.loss_fn(p, rcfg, {"tokens": t}))
    if dtype == "float32":
        rloss, rgrads = jax.jit(value_and_grad)(rstate["params"], jnp.asarray(tokens))
    else:
        with jax.disable_jit():
            rloss, rgrads = value_and_grad(rstate["params"], jnp.asarray(tokens))
    loss, grads = _port_grads(cfg, state["params"], tokens)
    want = [w for _, w in leaves(rgrads)]
    names = ["/".join(p) for p, _ in leaves(rgrads)]
    assert len(grads) == len(want)
    if dtype == "float32":
        np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=LOSS_TOL_F32)
        for name, g, w in zip(names, grads, want):
            _close_in_norm(g, w, GRAD_RTOL_F32, GRAD_ATOL_F32, name)
    else:
        np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=BF16_TOL)
        if arch in MOE_NORM_ARCHS:
            c32 = dataclasses.replace(rcfg, dtype="float32")
            p32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), rstate["params"])
            _, g32 = jax.jit(jax.value_and_grad(lambda p, t: rlm.loss_fn(p, c32, {"tokens": t})))(
                p32, jnp.asarray(tokens))
            for name, g, w, w32 in zip(names, grads, want, [x for _, x in leaves(g32)]):
                assert g.dtype == torch.bfloat16, name
                err, own = (float(np.linalg.norm(_f32(g) - _f32(w))),
                            float(np.linalg.norm(_f32(w) - _f32(w32))))
                assert err <= own / 4, f"{name}: |g - w| {err:.3e}, |w - w32| {own:.3e}"
            return
        for name, g, w in zip(names, grads, want):
            assert g.dtype == torch.bfloat16, name
            scale = max(float(np.abs(_f32(w)).max()), 1e-30)
            np.testing.assert_allclose(_f32(g), _f32(w), rtol=BF16_TOL, atol=BF16_TOL * scale,
                                       err_msg=name)


def test_remat_recomputes_the_same_gradients():
    """``remat="full"`` (each period under ``torch.utils.checkpoint``) gives
    ``remat="none"``'s loss and gradients bit for bit; ``"dots"``, which no
    config uses, waits for its slice."""
    _, _, _, cfg, _, state = _states("stablelm-1.6b", "float32")
    tokens = _tokens(cfg, 2, 24)
    full = _port_grads(cfg, state["params"], tokens)
    none = _port_grads(dataclasses.replace(cfg, remat="none"), state["params"], tokens)
    assert torch.equal(full[0], none[0])
    assert all(torch.equal(a, b) for a, b in zip(full[1], none[1]))
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        _port_grads(dataclasses.replace(cfg, remat="dots"), state["params"], tokens)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """One ``adamw_update`` from a mid-training state (step 7, random
    moments) on the same gradients: new parameters, master, moments, step and
    metrics within 1e-6 relative (bf16 parameters: the f32 result cast, so at
    most one bf16 ulp apart where the f32 results straddle a rounding)."""
    rng = np.random.default_rng(4)
    jd, td = DTYPES[dtype]
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 2)}}

    def tree(fn, node=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in node.items()}

    p32 = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    g = tree(lambda s: (rng.standard_normal(s) * 3).astype(np.float32))
    m = tree(lambda s: (rng.standard_normal(s) * 0.1).astype(np.float32))
    v = tree(lambda s: np.abs(rng.standard_normal(s) * 0.1).astype(np.float32))
    oc_r, oc_t = radamw.OptConfig(warmup_steps=3, total_steps=20), tadamw.OptConfig(
        warmup_steps=3, total_steps=20)
    jmap = lambda t, dt: jax.tree_util.tree_map(lambda x: jnp.asarray(x, dt), t)
    tmap = lambda t, dt: {k: tmap(x, dt) if isinstance(x, dict) else torch.from_numpy(x).to(dt)
                          for k, x in t.items()}
    rstate = {"m": jmap(m, jnp.float32), "v": jmap(v, jnp.float32),
              "master": jmap(p32, jnp.float32), "step": jnp.asarray(7, jnp.int32)}
    tstate = {"m": tmap(m, torch.float32), "v": tmap(v, torch.float32),
              "master": tmap(p32, torch.float32), "step": torch.tensor(7, dtype=torch.int32)}
    rp, rs, rmet = radamw.adamw_update(jmap(g, jd), rstate, jmap(p32, jd), oc_r)
    tp, ts, tmet = tadamw.adamw_update(tmap(g, td), tstate, tmap(p32, td), oc_t)
    assert int(ts["step"]) == 8 and ts["step"].dtype == torch.int32
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[name]), float(rmet[name]), rtol=ADAMW_RTOL)
    for want, got in ((rs["m"], ts["m"]), (rs["v"], ts["v"]), (rs["master"], ts["master"])):
        for (path, w), (_, x) in zip(leaves(want), leaves(got)):
            np.testing.assert_allclose(_f32(x), _f32(w), rtol=ADAMW_RTOL, atol=1e-12,
                                       err_msg=str(path))
    for (path, w), (_, x) in zip(leaves(rp), leaves(tp)):
        assert x.dtype == td
        tol = ADAMW_RTOL if dtype == "float32" else 2 ** -8
        np.testing.assert_allclose(_f32(x), _f32(w), rtol=tol, atol=1e-12, err_msg=str(path))


def test_schedule_matches_reference():
    """Warmup, cosine decay and the floor at 0.1 lr, at 1e-6 relative."""
    oc_r, oc_t = radamw.OptConfig(warmup_steps=5, total_steps=40), tadamw.OptConfig(
        warmup_steps=5, total_steps=40)
    for s in (0, 1, 4, 5, 6, 20, 39, 40, 60):
        want = float(radamw.schedule(oc_r, jnp.asarray(s, jnp.int32)))
        got = float(tadamw.schedule(oc_t, torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=ADAMW_RTOL, atol=1e-12)


def test_train_step_matches_reference():
    """One ``make_train_step`` step with two microbatches against the
    reference's jitted step, f32, from the same JAX-initialised state: loss
    and ``grad_norm`` 1e-5; moments at the gradient tolerance (1e-4 relative
    in norm); parameters and master within 6e-6 absolute; ``step`` 1; the
    input state unchanged."""
    _check_train_step("stablelm-1.6b")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"])
def test_moe_train_step_matches_reference(arch):
    """:func:`test_train_step_matches_reference` on the MoE smoke configs:
    the loss with its aux term, the router's and the experts' moments and
    updates."""
    _check_train_step(arch)


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_ssm_train_step_matches_reference(arch):
    """:func:`test_train_step_matches_reference` on the smoke configs with
    recurrent mixers (xlstm's mLSTM and sLSTM; jamba's mamba beside
    attention and MoE): autograd through the plain scans against the
    reference's scans and the sLSTM's custom VJP."""
    _check_train_step(arch)


def _check_train_step(arch: str) -> None:
    rcfg, rspec, rstate, cfg, spec, state = _states(arch, "float32")
    tokens = _tokens(cfg, 4, 32, seed=5)
    rnew, rmet = jax.jit(rstep.make_train_step(rcfg, rspec))(
        rstate, rstep.microbatch_reshape({"tokens": jnp.asarray(tokens)}, 2))
    before = [x.clone() for x in tree_leaves(state)]
    new, met = tstep.make_train_step(cfg, spec)(
        state, tstep.microbatch_reshape({"tokens": torch.from_numpy(tokens)}, 2))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state)))
    np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]), rtol=LOSS_TOL_F32)
    np.testing.assert_allclose(float(met["grad_norm"]), float(rmet["grad_norm"]),
                               rtol=LOSS_TOL_F32)
    np.testing.assert_allclose(float(met["lr"]), float(rmet["lr"]), rtol=ADAMW_RTOL)
    assert int(new["opt"]["step"]) == 1
    want = train_state_to_numpy(new)
    rwant = jax.tree_util.tree_map(np.asarray, rnew)
    for part in ("m", "v"):
        for (path, w), (_, x) in zip(leaves(rwant["opt"][part]), leaves(want["opt"][part])):
            _close_in_norm(x, w, GRAD_RTOL_F32, 0.0, f"{part} {path}")
    for got, ref_ in ((want["params"], rwant["params"]),
                      (want["opt"]["master"], rwant["opt"]["master"])):
        for (path, w), (_, x) in zip(leaves(ref_), leaves(got)):
            np.testing.assert_allclose(x, w, rtol=0, atol=STEP_PARAM_ATOL, err_msg=str(path))


def test_microbatch_reshape_matches_reference():
    x = np.arange(6 * 5, dtype=np.int32).reshape(6, 5)
    want = rstep.microbatch_reshape({"tokens": jnp.asarray(x)}, 3)["tokens"]
    got = tstep.microbatch_reshape({"tokens": torch.from_numpy(x)}, 3)["tokens"]
    assert tuple(got.shape) == (3, 2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tstep.microbatch_reshape({"tokens": torch.from_numpy(x)}, 4)


def test_train_state_round_trips_through_numpy():
    """``train_state_to_numpy`` inverts ``train_state_from_numpy`` bit for
    bit, bf16 parameters included, and a mismatched tree raises."""
    _, _, rstate, cfg, spec, state = _states("stablelm-1.6b", "bfloat16")
    tree = train_state_to_numpy(state)
    back = train_state_from_numpy(tree, cfg, spec, device="cpu")
    for a, b in zip(tree_leaves(state), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ref_tree = jax.tree_util.tree_map(np.asarray, rstate)
    for (pa, a), (pb, b) in zip(leaves(ref_tree), leaves(tree)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    bad = {**tree, "opt": {k: v for k, v in tree["opt"].items() if k != "master"}}
    with pytest.raises(ValueError):
        train_state_from_numpy(bad, cfg, spec, device="cpu")
    assert isinstance(back["params"], ParamTree)
    np.testing.assert_array_equal(
        np.asarray(lm_params_to_numpy(back["params"])["embed"], np.float32),
        np.asarray(lm_params_to_numpy(lm_params_from_numpy(
            ref_tree["params"], cfg, device="cpu"))["embed"], np.float32))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_train_cli_on_the_cpu_with_resume(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu --steps 3``
    prints the reference's lines and checkpoints; ``--resume --steps 5``
    resumes from step 3 with the pipeline's position."""
    ckpt = str(tmp_path / "ckpt")
    base = ["train", "--smoke", "--device", "cpu", "--seq", "32", "--ckpt", ckpt,
            "--ckpt-every", "2"]
    monkeypatch.setattr(sys, "argv", base + ["--steps", "3"])
    ttrain.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"[train] arch=stablelm-1.6b-smoke params={get_config('stablelm-1.6b', True).param_count():,}"
    assert out[1].startswith("[train] curation: strategy=CB-OPT-GB attr=")
    assert out[2].startswith("[train] step=0 loss=") and out[3].startswith("[train] step=2 loss=")
    assert out[4].startswith("[train] done: loss ") and out[4].endswith("ckpts=[2, 3]")
    monkeypatch.setattr(sys, "argv", base + ["--steps", "5", "--resume"])
    ttrain.main()
    out = capsys.readouterr().out.splitlines()
    assert out[2] == "[train] resumed from step 3"
    assert out[3].startswith("[train] step=4 loss=")
    assert out[4].endswith("ckpts=[3, 4, 5]")  # keep-last-3
    monkeypatch.setattr(sys, "argv", ["train", "--no-smoke", "--arch", "llava-next-mistral-7b",
                                      "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        ttrain.main()


# ---------------------------------------------------------------------------
# The backward kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_KERNEL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_matches_plain(cuda, case, dtype):
    """The backward kernel against ``flash_attention_bwd_ref`` on the card
    on strided (B, S, H, D) views, its lse against the plain lse, within
    ``FLASH_TOL``; a rerun gives equal bits; one launch counted a call."""
    b, s, t, hq, hkv, d, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(s * 17 + t)
    packed_q = torch.randn((b, s, hq, d + 8), generator=gen, device=cuda).to(dtype)
    packed_kv = torch.randn((b, t, 2, hkv, d), generator=gen, device=cuda).to(dtype)
    q, k, v = packed_q[..., :d], packed_kv[:, :, 0], packed_kv[:, :, 1]
    do = torch.randn((b, s, hq, d), generator=gen, device=cuda).to(dtype)
    o, lse = flash_attention(q, k, v, causal=causal, window=window, layout="bshd",
                             return_lse=True)
    before, before_tc = LAUNCH_COUNTS[BWD_NAME], LAUNCH_COUNTS[BWD_TC_COUNTER]
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window, layout="bshd")
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window, layout="bshd")
    assert LAUNCH_COUNTS[BWD_NAME] == before + 2
    assert LAUNCH_COUNTS[BWD_TC_COUNTER] == before_tc + (2 if dtype == torch.bfloat16 else 0)
    qh, kh, vh, oh, doh = (x.transpose(1, 2) for x in (q, k, v, o, do))
    want = ref.flash_attention_bwd_ref(qh, kh, vh, oh, doh, causal, window)
    lse_want = ref.flash_attention_lse_ref(qh, kh, causal, window)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, lse_want, rtol=1e-5, atol=1e-5)
    tol = KERNEL_TOL[dtype]
    for g, g2, w, x in zip(got, again, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        assert torch.equal(g, g2)
        torch.testing.assert_close(g.float(), w.transpose(1, 2).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_attention_bwd_plan_matches_the_source(cuda):
    """``bwd_plan`` mirrors the source's ``tc::Plan`` at every head dim."""
    import ctypes

    from repro_torch.kernels import build

    lib = build.library(BWD_NAME)
    out = (ctypes.c_int * 8)()
    for d in range(1, 257):
        lib.flash_attention_bwd_plan(d, out)
        p = bwd_plan(d)
        assert list(out) == [p.width, p.kv_rows, p.q_rows, p.passes, p.dq_rows, p.dq_k_rows,
                             p.row_pad, p.stages], d


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_train_grads_on_the_card_match_the_plain_loop(cuda, dtype):
    """``attention_train``'s gradients through the kernels (forward with lse,
    backward) against the plain chunked loop's autograd on the same card
    tensors, relative to each gradient's scale: 1e-4 (f32), 2e-2 (bf16)."""
    cfg = dataclasses.replace(get_config("internlm2-20b", smoke=True), dtype=str(dtype)[6:])
    params = tlm.concrete_params(cfg, seed=3, device=cuda)
    p = tlm._period_slice(params["periods"], 0)["b0"]["mixer"]
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((2, 70, cfg.d_model), generator=gen, device=cuda).to(dtype)
    dy = torch.randn((2, 70, cfg.d_model), generator=gen, device=cuda).to(dtype)

    def grads(attention):
        leaves_ = {k: v.detach().requires_grad_() for k, v in p.items() if k != "ln"}
        xx = x.detach().requires_grad_()
        tree = {**leaves_, "ln": p["ln"]}
        old = TL.gqa_chunked
        TL.gqa_chunked = attention
        try:
            y = TL.attention_train(tree, cfg, xx, window=5)
        finally:
            TL.gqa_chunked = old
        return torch.autograd.grad(y, [xx, *leaves_.values()], dy)

    before = LAUNCH_COUNTS[BWD_NAME]
    got = grads(TL.gqa_chunked)
    assert LAUNCH_COUNTS[BWD_NAME] == before + 1
    want = grads(TL.gqa_chunked_plain)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol * scale
