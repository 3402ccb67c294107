"""PyTorch port: the tri-planar net's BN + PReLU dispatch
(``models/triplanar.py::_Branch.bn_prelu``, ``ops/bn_prelu.py``) on the CPU.

The kernel itself runs only on a card (``tests/test_torch_cuda.py`` holds
it to the module's BN and ``F.prelu`` bit for bit). Here: the BN module's
inference expression is the one it computed before, bit for bit; every
call the CPU makes takes the plain path and launches nothing; on a card
(the device check pointed at the CPU, the kernel faked) training and a
call autograd records take the plain path, float32 and bfloat16 eval calls
the kernel with the module's own tables; the kernel's wrapper refuses,
naming it, what it cannot take; and both engines take the kernel at each
of the five layers of each branch, and count it where the span
``infer.forward`` says.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from subcort_tpu_torch.engine import segment_volume
from subcort_tpu_torch.models import TriPlanarNet, TriPlanarSpec, init_params
from subcort_tpu_torch.models import triplanar
from subcort_tpu_torch.models.fcn import fcn_forward_slab
from subcort_tpu_torch.models.triplanar import _BatchNorm
from subcort_tpu_torch.ops import bn_prelu
from subcort_tpu_torch.utils import runtime
from subcort_tpu_torch.utils.graphs import count_launch

torch.set_num_threads(1)

SPEC = TriPlanarSpec(conv_filters=(8, 8, 8, 8, 8), fc_conv=16, fc_fc=16,
                     fc2=16)
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
        torch.float64: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(BITS[t.dtype])


def _former(x, mean, inv_std, gamma, beta, alpha):
    """The inference BN and PReLU as ``_BatchNorm.forward`` and ``F.prelu``
    computed them before the kernel came: four ops."""
    scale = (inv_std * gamma)[:, None, None]
    return F.prelu((x - mean[:, None, None]) * scale + beta[:, None, None],
                   alpha)


def _layer(c=7, seed=0, dtype=torch.float32):
    """A BN module of ``c`` channels with random tables, negative PReLU
    alphas among them, and an (5, c, 5, 3) input holding NaN, infinities,
    -0.0 and denormals: odd planes and a channel count no multiple of 4."""
    g = torch.Generator().manual_seed(seed)
    bn = _BatchNorm(c, 1e-4)
    with torch.no_grad():
        bn.mean.copy_(torch.randn(c, generator=g))
        bn.inv_std.copy_(torch.rand(c, generator=g) * 3 + 0.1)
        bn.gamma.copy_(torch.randn(c, generator=g))
        bn.beta.copy_(torch.randn(c, generator=g))
    alpha = torch.randn(c, generator=g)
    x = torch.randn(5, c, 5, 3, generator=g)
    flat = x.view(-1)
    flat[:8] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                             0.0, 1e-40, -1e-40, 1e-45])
    bn = bn.eval().requires_grad_(False).to(dtype)
    return x.to(dtype), bn, alpha.to(dtype)


def _tables(bn, alpha):
    return (bn.mean, bn.inv_std, bn.gamma, bn.beta, alpha)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_plain_is_the_former_expression(dtype):
    """The BN module in eval mode then ``F.prelu``, the plain path and the
    kernel's yardstick, give the expression they computed before, bit for
    bit, special values and every dtype included."""
    x, bn, alpha = _layer(dtype=dtype)
    assert torch.equal(_bits(F.prelu(bn(x), alpha)),
                       _bits(_former(x, *_tables(bn, alpha))))


def _branch_net(case):
    net = TriPlanarNet.from_params(
        init_params(SPEC, torch.Generator().manual_seed(1)), SPEC, "cpu")
    if case == "bfloat16":
        net = net.to(torch.bfloat16)
    elif case in ("training", "autograd"):
        net = TriPlanarNet.from_params(
            init_params(SPEC, torch.Generator().manual_seed(1)), SPEC,
            "cpu", trainable=True)
        if case == "autograd":
            net.eval()
    return net


def _as_if_on_a_card(monkeypatch):
    """The dispatch as a card runs it: ``_Branch.bn_prelu`` takes the CPU
    for the card, and the kernel is faked by one that checks the wrapper
    would refuse the call only for its device, counts a launch, and
    returns the former expression."""
    calls = []

    def kernel(x, *tables):
        assert bn_prelu._refusal(x, tables).startswith("device")
        calls.append(tuple(x.shape))
        count_launch(bn_prelu._add_launches)
        return _former(x, *tables)

    monkeypatch.setattr(triplanar, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(bn_prelu, "bn_prelu", kernel)
    return calls


def _run_layers(net):
    """Every layer of the axial branch on one input: how many launches, and
    whether each output equals the module's BN and ``F.prelu``."""
    branch = net.axial
    dtype = next(net.parameters()).dtype
    x = torch.randn(3, 8, 6, 6, generator=torch.Generator().manual_seed(2),
                    dtype=dtype)
    before = bn_prelu.LAUNCHES
    for i in (1, 2, 3, 4, 5):
        bn, alpha = getattr(branch, f"bn{i}"), getattr(branch, f"prelu{i}")
        got = branch.bn_prelu(i, x)
        assert torch.equal(_bits(got.detach()),
                           _bits(F.prelu(bn(x), alpha).detach()))
        assert got.requires_grad == (torch.is_grad_enabled()
                                     and alpha.requires_grad)
    return bn_prelu.LAUNCHES - before


@pytest.mark.parametrize("case", ["cpu", "bfloat16", "training",
                                  "autograd"])
def test_what_the_cpu_runs_takes_the_plain_path(case):
    """A CPU float32 net, a bfloat16 net, a net in training mode and an
    eval-mode net whose parameters want gradients under grad mode: off the
    card each layer launches nothing and gives the module's BN and
    ``F.prelu`` bit for bit (for training, the batch's statistics)."""
    assert _run_layers(_branch_net(case)) == 0


@pytest.mark.parametrize("case,launches", [("float32", 5), ("bfloat16", 5),
                                           ("training", 0),
                                           ("autograd", 0)])
def test_on_a_card_only_training_and_autograd_take_the_plain_path(
        monkeypatch, case, launches):
    """On a card an eval-mode float32 or bfloat16 net takes the kernel at
    each layer, with the module's own tables; a net in training mode and a
    call autograd records take the plain path and launch nothing."""
    _as_if_on_a_card(monkeypatch)
    with torch.no_grad() if launches else torch.enable_grad():
        assert _run_layers(_branch_net(case)) == launches


def _refused(case):
    x, bn, alpha = _layer()
    tables = list(_tables(bn, alpha))
    if case == "float64":
        x, tables = x.double(), [t.double() for t in tables]
    elif case == "mixed":
        tables[4] = tables[4].to(torch.bfloat16)
    elif case == "strided":
        x = x.transpose(2, 3)
    elif case == "three_dims":
        x = x[0]
    elif case == "table":
        tables[4] = tables[4][:-1]
    elif case == "channels":
        c = bn_prelu.MAX_CHANNELS + 1
        x, tables = torch.empty((1, c, 1, 1)), [torch.empty(c)] * 5
    elif case == "size":
        x = torch.empty((1, 7, 2 ** 31 // 7 + 1, 1), device="meta")
    elif case == "autograd":
        tables[4] = tables[4].requires_grad_()
    return x, tables


@pytest.mark.parametrize("case,word", [
    ("float64", "dtype"), ("mixed", "dtype"), ("strided", "layout"),
    ("three_dims", "layout"), ("table", "layout"), ("channels", "channels"),
    ("size", "size"), ("autograd", "autograd"), ("cpu", "device")])
def test_the_kernel_refuses_what_it_cannot_take(case, word):
    """The wrapper raises, naming the cause, for a dtype neither float32
    nor bfloat16 or tables of another, a strided or 3-D input, a table of
    another length, too many channels, a sample of 2**31 values, a call
    autograd records and a CPU tensor; it launches nothing."""
    x, tables = _refused(case)
    before = bn_prelu.LAUNCHES
    with torch.enable_grad(), pytest.raises(
            ValueError, match=f"no bn_prelu kernel for this call: {word}"):
        bn_prelu.bn_prelu(x, *tables)
    assert bn_prelu.LAUNCHES == before


def test_both_engines_take_the_kernel_at_every_layer(monkeypatch):
    """On a card, a patch forward and a dense slab each take the kernel
    once per layer and branch (15), and give what they gave without."""
    net = _branch_net("cpu")
    g = torch.Generator().manual_seed(3)
    views = [torch.randn(4, 32, 32, generator=g) for _ in range(3)]
    atlas = torch.rand(4, 15, generator=g)
    slab = torch.randn(6 + 31, 5 + 31, 4 + 31, generator=g)
    vecs = torch.rand(6 * 5 * 4, 15, generator=g)
    with torch.inference_mode():
        want = (net(*views, atlas), fcn_forward_slab(net, slab, vecs, True))
        calls = _as_if_on_a_card(monkeypatch)
        before = bn_prelu.LAUNCHES
        p = net(*views, atlas)
        assert len(calls) == 15 and bn_prelu.LAUNCHES == before + 15
        assert {s[0] for s in calls} == {4}
        got = fcn_forward_slab(net, slab, vecs, True)
        assert len(calls) == 30 and bn_prelu.LAUNCHES == before + 30
    assert torch.equal(p, want[0])
    for g_, w_ in zip(got, want[1]):
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("engine,chunk", [("patch", 32), ("fcn", None)])
def test_forward_span_counts_the_launches(monkeypatch, engine, chunk):
    """``segment_volume``'s ``infer.forward`` spans carry ``bn_prelu``, the
    launches each made on its thread: 15 a patch chunk or a dense slab on
    the dispatch a card takes, 0 on the CPU."""
    rng = np.random.default_rng(4)
    image = (rng.random((20, 22, 18)) * 800 + 100).astype(np.int16)
    atlas = rng.random((20, 22, 18, 15)).astype(np.float32)
    atlas /= atlas.sum(-1, keepdims=True)
    centers = np.stack(np.nonzero(np.ones((4, 5, 4), bool)), 1).astype(
        np.int32) + 8
    net = _branch_net("cpu")
    kw = dict(engine=engine) if chunk is None else dict(engine=engine,
                                                        chunk=chunk)
    for on_card in (False, True):
        if on_card:
            _as_if_on_a_card(monkeypatch)
        before = bn_prelu.LAUNCHES
        runtime.clear_records()
        with runtime.recording():
            segment_volume(net, image, atlas, centers, **kw)
        forwards = [r for r in runtime.records() if r.name == "infer.forward"]
        runtime.clear_records()
        parts = len(forwards)
        chunks = -(-len(centers) // chunk) if chunk else parts
        want = 15 * chunks if on_card else 0
        assert sum(r.attrs["bn_prelu"] for r in forwards) == want
        assert bn_prelu.LAUNCHES == before + want
