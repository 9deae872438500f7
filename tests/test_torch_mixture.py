"""The port's mixture log-density (``multivae_tpu_torch/ops/mixture.py``)
against the JAX package's on the CPU.

On CPU tensors the port runs its plain version, a PyTorch copy of
``mixture_log_density_xla``; these tests hold it against that XLA
composition and against the TPU kernel itself (``_mixture_pallas`` in
Pallas interpret mode), values and gradients, for both distributions. The
CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import multivae_tpu.ops.pallas_mixture as pm
from multivae_tpu_torch.ops import mixture as mx
from multivae_tpu_torch.ops.kdist import mixture_logsumexp

torch.set_num_threads(2)

MQ, MZ, K, B, D = 3, 3, 4, 16, 32
# float32 on both sides, same formula, sums over D=32 terms in another
# order: a few ulps of |out| ~ 10^2 for the values; gradients go through
# exp(lq - out), so they carry that absolute error as a relative one.
OUT_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def interpret_mode():
    pm._INTERPRET = True
    yield
    pm._INTERPRET = False


def _inputs(seed=0, fully_masked_column=False):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(MZ, K, B, D)).astype(np.float32)
    mus = rng.normal(size=(MQ, B, D)).astype(np.float32)
    sig = rng.uniform(0.5, 1.5, size=(MQ, B, D)).astype(np.float32)
    mask = np.ones((MQ, B), np.float32)
    mask[1, :5] = 0.0
    if fully_masked_column:
        mask[:, 0] = 0.0
    g = rng.normal(size=(MZ, K, B)).astype(np.float32)
    return z, mus, sig, mask, g


def _torch_value_and_grads(fn, z, mus, sig, mask, g, dist):
    leaves = [torch.tensor(a, requires_grad=True) for a in (z, mus, sig)]
    out = fn(*leaves, torch.tensor(mask), dist)
    grads = torch.autograd.grad(out, leaves, torch.tensor(g))
    return out.detach().numpy(), [t.numpy() for t in grads]


def _jax_value_and_grads(fn, z, mus, sig, mask, g, dist):
    def loss(z, m, s):
        out = fn(z, m, s, jnp.asarray(mask), dist)
        return (out * g).sum(), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(z), jnp.asarray(mus), jnp.asarray(sig))
    return np.asarray(out), [np.asarray(t) for t in grads]


@pytest.mark.parametrize("dist", ["laplace", "normal"])
def test_plain_matches_jax_xla(dist):
    args = _inputs()
    ref = np.asarray(pm.mixture_log_density_xla(
        *(jnp.asarray(a) for a in args[:4]), dist))
    out = mx.mixture_log_density_plain(*(torch.tensor(a) for a in args[:4]), dist)
    np.testing.assert_allclose(out.numpy(), ref, **OUT_TOL)


@pytest.mark.parametrize("dist", ["laplace", "normal"])
def test_plain_gradients_match_jax_xla(dist):
    args = _inputs(seed=1)
    out_t, grads_t = _torch_value_and_grads(mx.mixture_log_density_plain,
                                            *args, dist)
    out_j, grads_j = _jax_value_and_grads(pm.mixture_log_density_xla,
                                          *args, dist)
    np.testing.assert_allclose(out_t, out_j, **OUT_TOL)
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt, gj, **GRAD_TOL)


@pytest.mark.parametrize("dist", ["laplace", "normal"])
def test_plain_matches_tpu_kernel_in_interpret_mode(interpret_mode, dist):
    """Values and the hand-written VJP of the Pallas kernel (forward and
    backward kernels, run in interpret mode) vs the port's plain version."""
    args = _inputs(seed=2)
    out_t, grads_t = _torch_value_and_grads(mx.mixture_log_density_plain,
                                            *args, dist)
    out_p, grads_p = _jax_value_and_grads(pm._mixture_pallas, *args, dist)
    np.testing.assert_allclose(out_t, out_p, **OUT_TOL)
    for gt, gp in zip(grads_t, grads_p):
        np.testing.assert_allclose(gt, gp, **GRAD_TOL)


@pytest.mark.parametrize("dist", ["laplace", "normal"])
def test_fully_masked_column(dist):
    """A column with every expert masked gives the XLA value (-1e30) and
    exactly zero gradient, and leaves the other columns' gradients finite
    and equal to JAX's."""
    args = _inputs(seed=3, fully_masked_column=True)
    out_t, grads_t = _torch_value_and_grads(mx.mixture_log_density_plain,
                                            *args, dist)
    out_j, grads_j = _jax_value_and_grads(pm.mixture_log_density_xla,
                                          *args, dist)
    np.testing.assert_allclose(out_t, out_j, **OUT_TOL)
    for gt, gj in zip(grads_t, grads_j):
        assert np.isfinite(gt).all()
        np.testing.assert_allclose(gt, gj, **GRAD_TOL)
    assert (grads_t[0][:, :, 0] == 0).all()
    assert (grads_t[1][:, 0] == 0).all() and (grads_t[2][:, 0] == 0).all()


def test_masked_expert_gets_zero_gradient():
    z, mus, sig, mask, g = _inputs(seed=4)
    _, grads = _torch_value_and_grads(mx.mixture_log_density_plain,
                                      z, mus, sig, mask, g, "laplace")
    assert (grads[1][1, :5] == 0).all() and (grads[2][1, :5] == 0).all()
    assert (grads[1][1, 5:] != 0).any()


def test_cpu_dispatch_runs_plain_version_without_launching():
    args = [torch.tensor(a) for a in _inputs(seed=5)[:4]]
    before = dict(mx.launches)
    out = mixture_logsumexp(*args, "laplace_with_softmax")
    assert mx.launches == before
    torch.testing.assert_close(out, mx.mixture_log_density_plain(*args, "laplace"),
                               rtol=0, atol=0)


def test_kernel_input_checks():
    """What the CUDA path refuses, checked before any launch: another
    dist, a non-float32 or non-contiguous input, an input off the card."""
    z, mus, sig, mask = (torch.tensor(a) for a in _inputs()[:4])
    with pytest.raises(ValueError, match="dist"):
        mx._check_inputs(z, mus, sig, mask, "cauchy")
    with pytest.raises(TypeError, match="float32"):
        mx._check_inputs(z.double(), mus, sig, mask, "laplace")
    with pytest.raises(ValueError, match="contiguous"):
        mx._check_inputs(z.transpose(2, 3), mus, sig, mask, "laplace")
    with pytest.raises(ValueError, match="CUDA device"):
        mx._check_inputs(z, mus, sig, mask, "laplace")


def test_mixed_devices_never_reach_the_plain_version():
    """Only all-CPU inputs take the plain version; anything else goes to
    the kernel's checks (here: a meta-device z is refused)."""
    z, mus, sig, mask = (torch.tensor(a) for a in _inputs()[:4])
    with pytest.raises(ValueError, match="CUDA device"):
        mx.mixture_log_density(z.to("meta"), mus, sig, mask, "laplace")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """With no nvcc, building a kernel fails loudly."""
    from multivae_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build(["mixture"])


# --- the autograd glue around the CUDA kernels, on the CPU -----------------
# ``_fwd_reference`` and ``_bwd_reference`` compute what the C entries
# ``mixture_fwd`` and ``mixture_bwd`` compute, with the same arguments; here
# they stand in for the launches so that ``_MixtureLogDensity`` runs on CPU
# tensors. Tolerances as above: float32 on both sides, sums in another order.


class _OpsOutsideLaunches(TorchDispatchMode):
    """Records every aten op that runs outside a (stand-in) launch."""

    def __init__(self, state):
        super().__init__()
        self.state = state
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.state["inside"]:
            self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.fixture
def reference_launches(monkeypatch):
    """Replace both launches by their plain stand-ins; returns the list of
    (kind, result) of every launch and the flag set while one runs."""
    calls, state = [], {"inside": False}

    def wrap(kind_of, fn):
        def launch(*args):
            state["inside"] = True
            try:
                result = fn(*args)
            finally:
                state["inside"] = False
            calls.append((kind_of(args), result))
            return result
        return launch

    monkeypatch.setattr(mx, "_launch_fwd", wrap(lambda a: "fwd", mx._fwd_reference))
    monkeypatch.setattr(mx, "_launch_bwd", wrap(
        lambda a: "bwd" if a[-1] else "bwd_dz", mx._bwd_reference))
    return calls, state


def _glue(z, mus, sig, mask, dist):
    return mx._MixtureLogDensity.apply(z, mus, sig, mask, dist)


@pytest.mark.parametrize("dist", ["laplace", "normal"])
def test_glue_matches_jax_xla(reference_launches, dist):
    """Value and all three gradients of the autograd Function (stand-in
    launches) against ``mixture_log_density_xla``, with a masked expert and
    a fully masked column; the full backward runs when mus and sigmas need
    gradients."""
    calls, _ = reference_launches
    args = _inputs(seed=6, fully_masked_column=True)
    out_t, grads_t = _torch_value_and_grads(_glue, *args, dist)
    out_j, grads_j = _jax_value_and_grads(pm.mixture_log_density_xla, *args, dist)
    assert [k for k, _ in calls] == ["fwd", "bwd"]
    np.testing.assert_allclose(out_t, out_j, **OUT_TOL)
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt, gj, **GRAD_TOL)
    assert (grads_t[0][:, :, 0] == 0).all()
    assert (grads_t[1][:, 0] == 0).all() and (grads_t[2][:, 0] == 0).all()
    assert (grads_t[1][1, :5] == 0).all() and (grads_t[2][1, :5] == 0).all()


@pytest.mark.parametrize("dist", ["laplace", "normal"])
def test_glue_logc_side_output(reference_launches, dist):
    """The forward launch returns logc = -sum_d log sig - D*c for the
    backward; the backward receives it, and the forward's out, unchanged."""
    calls, _ = reference_launches
    z, mus, sig, mask, g = (torch.tensor(a) for a in _inputs(seed=7))
    z = z.requires_grad_()
    out = _glue(z, mus, sig, mask, dist)
    out.backward(torch.tensor(_inputs(seed=7)[4]))
    (_, (out_r, logc)), _ = calls
    c = mx._LOG2 if dist == "laplace" else mx._HALF_LOG_2PI
    torch.testing.assert_close(logc, -torch.log(sig).sum(-1) - D * c)
    torch.testing.assert_close(out.detach(), out_r.view(MZ, K, B), rtol=0, atol=0)


@pytest.mark.parametrize("dist", ["laplace", "normal"])
def test_glue_dz_only_backward(reference_launches, dist):
    """With mus and sigmas detached (the DReG path) the backward launches
    the dz-only kernel, gets None for dmu and dsig, and gives the same dz as
    the full backward."""
    calls, _ = reference_launches
    z, mus, sig, mask, g = (torch.tensor(a) for a in _inputs(seed=8))
    z_full = z.clone().requires_grad_()
    leaves = [z_full, mus.clone().requires_grad_(), sig.clone().requires_grad_()]
    dz_full = torch.autograd.grad(_glue(*leaves, mask, dist), leaves, g)[0]
    z_only = z.clone().requires_grad_()
    (dz_only,) = torch.autograd.grad(_glue(z_only, mus, sig, mask, dist),
                                     [z_only], g)
    kinds = [k for k, _ in calls]
    assert kinds == ["fwd", "bwd", "fwd", "bwd_dz"]
    _, dmu, dsig = calls[-1][1]
    assert dmu is None and dsig is None
    torch.testing.assert_close(dz_only, dz_full, rtol=0, atol=0)
    _, grads_j = _jax_value_and_grads(pm.mixture_log_density_xla,
                                      *_inputs(seed=8), dist)
    np.testing.assert_allclose(dz_only.numpy(), grads_j[0], **GRAD_TOL)


@pytest.mark.parametrize("needs", [(True, False), (False, True)])
def test_glue_one_parameter_gradient_takes_full_backward(reference_launches, needs):
    """If either mus or sigmas needs a gradient, the full backward runs."""
    calls, _ = reference_launches
    z, mus, sig, mask, g = (torch.tensor(a) for a in _inputs(seed=9))
    mus.requires_grad_(needs[0])
    sig.requires_grad_(needs[1])
    _glue(z, mus, sig, mask, "laplace").backward(g)
    assert [k for k, _ in calls] == ["fwd", "bwd"]
    assert (mus.grad is not None) == needs[0] and (sig.grad is not None) == needs[1]


def test_glue_forward_is_one_launch_without_torch_prep(reference_launches):
    """A forward is exactly one launch, and outside it only views run: no
    1/sigma, log, sum or affine prep in torch."""
    calls, state = reference_launches
    z, mus, sig, mask = (torch.tensor(a) for a in _inputs(seed=10)[:4])
    mode = _OpsOutsideLaunches(state)
    with mode:
        _glue(z, mus, sig, mask, "laplace")
    assert [k for k, _ in calls] == ["fwd"]
    assert mode.ops and all(op.is_view for op in mode.ops), mode.ops


def test_vectorized_path_needs_whole_float4_rows_and_alignment():
    t = torch.zeros(64)
    assert mx._vectorized(100, t)
    assert not mx._vectorized(101, t)              # D % 4 != 0: scalar path
    assert not mx._vectorized(100, t, t[1:])       # a view 4 bytes in


def test_kernel_takes_d_up_to_its_register_layout():
    """A row longer than one register tile (kMaxThreads threads of kElems
    coordinates each) is cut into tiles, so the input checks refuse no D:
    only shared memory, checked at launch, limits it. Here a D of three
    tiles and one more coordinate gets as far as the device check."""
    import re
    from multivae_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / "mixture.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    d = 3 * int(consts["kMaxThreads"]) * int(consts["kElems"]) + 1
    z = torch.zeros(1, 1, 1, d)
    mus = torch.zeros(1, 1, d)
    with pytest.raises(ValueError, match="CUDA device"):
        mx._check_inputs(z, mus, mus, torch.ones(1, 1), "laplace")


# --- the route: which design a launch takes ---------------------------------

@pytest.mark.parametrize("dtype, mode, d, mq, vec, design", [
    (torch.bfloat16, "fwd", 512, 5, True, "tma"),        # the MMVAE slice
    (torch.bfloat16, "bwd_dz", 512, 5, True, "tma"),
    (torch.bfloat16, "bwd", 512, 5, True, "tma"),        # the full backward
    (torch.bfloat16, "fwd", 32, 5, True, "tma"),         # mmvaeplus_k10
    (torch.bfloat16, "bwd_dz", 32, 5, True, "tma"),
    (torch.bfloat16, "fwd", 2048, 8, True, "tma"),       # the design's edge
    (torch.bfloat16, "bwd", 2048, 8, True, "tma"),
    (torch.bfloat16, "bwd_dz", 64, 1, True, "tma"),
    (torch.bfloat16, "fwd", 100, 3, False, "template"),  # D % 8 != 0: scalar
    (torch.bfloat16, "bwd_dz", 64, 11, True, "template"),  # MQ > 8
    (torch.bfloat16, "fwd", 2056, 2, True, "template"),  # rows over 2048
    (torch.bfloat16, "bwd", 100, 3, False, "template"),
    (torch.bfloat16, "bwd", 64, 11, True, "template"),
    (torch.bfloat16, "bwd", 2056, 2, True, "template"),
    (torch.float32, "fwd", 512, 5, True, "template"),
    (torch.float32, "bwd_dz", 512, 5, True, "template"),
])
def test_route(dtype, mode, d, mq, vec, design):
    assert mx.route(dtype, mode, d, mq, vec) == design


def test_route_limits_are_the_kernel_sources():
    """The tensor-copy route's limits are mixture.cu's: kMaxQ experts in
    registers, kMaxThreads threads of kElems coordinates a row."""
    import re
    from multivae_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / "mixture.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert mx.TMA_MAX_Q == consts["kMaxQ"]
    assert mx.TMA_MAX_D == consts["kMaxThreads"] * consts["kElems"]
    bf16 = (cuda_build.CSRC_DIR / "mixture_bf16.cu").read_text()
    assert "int mixture_fwd_tma(" in bf16 and "int mixture_bwd_dz_tma(" in bf16
    assert "int mixture_bwd_tma(" in bf16


@pytest.fixture
def reference_entries(monkeypatch):
    """Replace the C entries by their plain stand-ins, writing the outputs
    the wrapper allocated; returns the list of (kernel, design) launched."""
    calls = []

    def run_fwd(design, z3, mus, sigmas, mask, out, logc, laplace, vec):
        calls.append(("fwd", design))
        o, c = mx._fwd_reference(z3, mus, sigmas, mask, laplace)
        out.copy_(o)
        logc.copy_(c)

    def run_bwd(design, z3, mus, sigmas, logc, mask, out, g, dz, dmu, dsig, laplace, vec):
        calls.append(("bwd" if dmu is not None else "bwd_dz", design))
        grads = mx._bwd_reference(z3, mus, sigmas, logc, mask, out, g, laplace,
                                  dmu is not None)
        for dst, src in zip((dz, dmu, dsig), grads):
            if dst is not None:
                dst.copy_(src)

    monkeypatch.setattr(mx, "_run_fwd", run_fwd)
    monkeypatch.setattr(mx, "_run_bwd", run_bwd)
    return calls


def _bf16_inputs(d, seed=11):
    rng = np.random.default_rng(seed)
    z = torch.tensor(rng.normal(size=(2, 3, 8, d)), dtype=torch.float32).bfloat16()
    mus = torch.tensor(rng.normal(size=(3, 8, d)), dtype=torch.float32).bfloat16()
    sig = torch.tensor(rng.uniform(0.5, 1.5, size=(3, 8, d)),
                       dtype=torch.float32).bfloat16()
    mask = torch.ones(3, 8, dtype=torch.bfloat16)
    mask[1, :3] = 0.0   # a masked expert on some columns
    mask[:, 0] = 0.0    # a fully masked column
    g = torch.tensor(rng.normal(size=(2, 3, 8)), dtype=torch.float32)
    return z, mus, sig, mask, g


@pytest.mark.parametrize("dist", ["laplace", "normal"])
@pytest.mark.parametrize("d, design", [(16, "tma"), (12, "template")])
def test_bf16_glue_through_the_routed_entries(reference_entries, dist, d, design):
    """The DReG path on bf16 inputs (mus and sigmas detached) asks the
    entries of the design ``route`` names for the forward and the dz-only
    backward, counts them under ``fwd_bf16`` and ``bwd_dz_bf16``, returns
    a float32 out and a bf16 dz, against the plain version in float64 on
    the same bf16 values, with exactly zero dz on the fully masked
    column."""
    calls = reference_entries
    z, mus, sig, mask, g = _bf16_inputs(d)
    before = dict(mx.launches)
    z_leaf = z.clone().requires_grad_()
    out = _glue(z_leaf, mus, sig, mask, dist)
    (dz,) = torch.autograd.grad(out, [z_leaf], g)
    assert calls == [("fwd", design), ("bwd_dz", design)]
    assert mx.launches == {**before, "fwd_bf16": before["fwd_bf16"] + 1,
                           "bwd_dz_bf16": before["bwd_dz_bf16"] + 1}
    assert out.dtype == torch.float32 and dz.dtype == torch.bfloat16
    z64 = z.double().requires_grad_()
    out64 = mx.mixture_log_density_plain(z64, mus.double(), sig.double(), mask.double(),
                                         dist)
    (dz64,) = torch.autograd.grad(out64, [z64], g.double())
    np.testing.assert_allclose(out.detach()[..., 1:].numpy(),
                               out64.detach()[..., 1:].numpy(), rtol=1e-5, atol=1e-4)
    # float32 arithmetic, then one bf16 rounding of each entry
    assert (dz.double() - dz64).abs().max() <= 4e-3 * dz64.abs().max() + 1e-3
    assert (dz[:, :, 0] == 0).all()


def test_bf16_full_backward_and_float32_take_the_template(reference_entries):
    """With mus and sigmas needing gradients a bf16 backward takes the
    full backward of the design ``route`` names (``bwd_bf16``): the
    tensor-copy kernel on 16-byte rows, the template's at D % 8 != 0;
    float32 takes the template for every kernel."""
    calls = reference_entries
    for d in (16, 12):
        z, mus, sig, mask, g = _bf16_inputs(d)
        leaves = [t.clone().requires_grad_() for t in (z, mus, sig)]
        grads = torch.autograd.grad(_glue(*leaves, mask, "laplace"), leaves, g)
        assert all(t.dtype == torch.bfloat16 for t in grads)
    z32 = z.float().requires_grad_()
    torch.autograd.grad(_glue(z32, mus.float(), sig.float(), mask.float(), "laplace"),
                        [z32], g)
    assert calls == [("fwd", "tma"), ("bwd", "tma"), ("fwd", "template"),
                     ("bwd", "template"), ("fwd", "template"), ("bwd_dz", "template")]


@pytest.mark.parametrize("dist", ["laplace", "normal"])
def test_bf16_full_backward_through_the_tma_entry(reference_entries, dist):
    """The full backward on bf16 inputs at D = 16 asks the tensor-copy
    entry for it, counts it under ``bwd_bf16``, and gives bf16 dz, dmu and
    dsig against the plain version in float64 on the same bf16 values, with
    exactly zero dmu and dsig on the masked expert and zero gradients on the
    fully masked column."""
    calls = reference_entries
    z, mus, sig, mask, g = _bf16_inputs(16)
    before = dict(mx.launches)
    leaves = [t.clone().requires_grad_() for t in (z, mus, sig)]
    grads = torch.autograd.grad(_glue(*leaves, mask, dist), leaves, g)
    assert calls == [("fwd", "tma"), ("bwd", "tma")]
    assert mx.launches == {**before, "fwd_bf16": before["fwd_bf16"] + 1,
                           "bwd_bf16": before["bwd_bf16"] + 1}
    assert all(t.dtype == torch.bfloat16 for t in grads)
    l64 = [t.double().requires_grad_() for t in (z, mus, sig)]
    grads64 = torch.autograd.grad(
        mx.mixture_log_density_plain(*l64, mask.double(), dist), l64, g.double())
    for got, want in zip(grads, grads64):
        # float32 arithmetic, then one bf16 rounding of each entry
        assert (got.double() - want).abs().max() <= 4e-3 * want.abs().max() + 1e-3
    dz, dmu, dsig = grads
    assert (dz[:, :, 0] == 0).all() and (dmu[:, 0] == 0).all() and (dsig[:, 0] == 0).all()
    assert (dmu[1, :3] == 0).all() and (dsig[1, :3] == 0).all()
    assert (dmu[1, 3:] != 0).any() and (dsig[1, 3:] != 0).any()


def test_bf16_full_backward_matches_tpu_kernel_in_interpret_mode(reference_entries,
                                                                 interpret_mode):
    """The bf16 full backward through the tensor-copy entry against the
    TPU kernel's ``_bwd_kernel`` (interpret mode) on the same bf16-rounded
    values, widened to float32 for JAX: Normal, since the TPU kernel takes
    the Laplace sign as +1 at z == mu, which bf16 values often hit, and no
    fully masked column, whose gradient the TPU kernel does not zero. Each
    entry carries one bf16 rounding (2^-8 of itself) beside float32
    noise."""
    calls = reference_entries
    z, mus, sig, mask, g = _bf16_inputs(16)
    mask[:, 0] = 1.0
    leaves = [t.clone().requires_grad_() for t in (z, mus, sig)]
    grads = torch.autograd.grad(_glue(*leaves, mask, "normal"), leaves, g)
    assert calls == [("fwd", "tma"), ("bwd", "tma")]
    _, grads_p = _jax_value_and_grads(pm._mixture_pallas,
                                      *(t.float().numpy() for t in (z, mus, sig, mask)),
                                      g.numpy(), "normal")
    for got, want in zip(grads, grads_p):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8 + 1e-4,
                                   atol=1e-4)
