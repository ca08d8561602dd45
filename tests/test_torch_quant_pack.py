"""K1 (quantize + P1 pack + row sums): the port's plain PyTorch version is
bit-equal to the reference Pallas kernel (interpret mode) and to
``ref.quantize_pack_ref``, for ragged M, odd K, and every feasible layout
of W2A2 and W4A4."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import packing as jpack  # noqa: E402
from repro.kernels import quant_pack as jqp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.kernels import ops, plan as tplan  # noqa: E402
from repro_torch.kernels import quant_pack as tqp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(2)


def _cases():
    for w, a in ((2, 2), (4, 4)):
        for js in jpack.layout_family(w, a):
            yield pytest.param(js, id=str(js))


@pytest.mark.parametrize("js", list(_cases()))
def test_plain_quantize_pack_bit_equal(js):
    ts = tpack.PackSpec.parse(str(js))
    rng = np.random.default_rng(js.shift + js.n_pack)
    m, k = 5, 37                          # ragged rows, odd K
    x = (rng.standard_normal((m, k)) * 1.5).astype(np.float32)
    scale = np.float32(1.0 / np.sqrt((1 << js.a_bits) - 1))
    zp = np.int32(1 << (js.a_bits - 1))
    want_l, want_rs = jqp.quantize_pack(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(zp), js,
        block_m=8, block_k=16, interpret=True)
    ref_l, ref_rs = jref.quantize_pack_ref(jnp.asarray(x), scale, zp, js)
    got_l, got_rs = tqp.quantize_pack_torch(
        torch.from_numpy(x), torch.tensor(scale), torch.tensor(zp), ts)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_rs.numpy(), np.asarray(want_rs))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(got_rs.numpy()[:, 0], np.asarray(ref_rs))
    assert got_l.dtype == ts.lane_dtype
    # the port's oracle and the dispatched entry point agree too
    o_l, o_rs = tref.quantize_pack_ref(torch.from_numpy(x),
                                       torch.tensor(scale), int(zp), ts)
    np.testing.assert_array_equal(o_l.numpy(), got_l.numpy())
    np.testing.assert_array_equal(o_rs.numpy(), got_rs.numpy()[:, 0])
    d_l, d_rs = ops.quantize_pack(torch.from_numpy(x)[None],
                                  torch.tensor(scale), torch.tensor(zp), ts)
    np.testing.assert_array_equal(d_l[0].numpy(), got_l.numpy())
    np.testing.assert_array_equal(d_rs[0].numpy(), got_rs.numpy())


def test_cpu_tensors_take_the_plain_version():
    """'auto' on CPU tensors resolves to the plain version; asking for the
    CUDA kernel with CPU tensors raises instead of falling back."""
    ts = tpack.PackSpec(2, 2)
    tqp.reset_counts()
    x = torch.randn(3, 8)
    ops.quantize_pack(x, torch.tensor(0.5), torch.tensor(2), ts)
    assert (tqp.plain_calls, tqp.kernel_launches) == (1, 0)
    assert tplan.resolve_backend("auto", "cpu") == "torch"
    with pytest.raises(ValueError):
        ops.quantize_pack(x, torch.tensor(0.5), torch.tensor(2), ts,
                          backend="cuda")
    with pytest.raises(ValueError):
        tqp.quantize_pack_cuda(x, 0.5, 2, ts)
