"""The port's roofline arithmetic and per-rank counter
(``runtime/roofline.py``, ``runtime/hlo_bytes.py``, ``runtime/hloprof.py``,
``runtime/flags.py``), on the CPU, in one process.

- The ring-model wire bytes equal the reference's ``collective_bytes`` on
  its own HLO example (``tests/test_roofline.py``), op by op, when the same
  collectives are fed as (op, group size, operand bytes) records.
- The roofline terms on the H100's data-sheet constants, the compute term
  split by product dtype, the collective term by each group's link.
- The counter on hand-counted programs: a matmul, a cast (counted), views
  and aliases (not counted), an in-place add, a copy; a kernel call through
  ``kernels.ops`` counted at the kernel's formula on the plain (CPU) route,
  with nothing counted inside it.
"""
import pytest
import torch

from repro.runtime import roofline as jroofline

from repro_torch.kernels import ops
from repro_torch.runtime import flags, hlo_bytes, hloprof, roofline

from test_roofline import HLO

F32, BF16 = 4, 2


def _records():
    """The reference example's collectives as the port observes them: the
    operand of each call. The async permute-start's tuple result (its input
    and output buffers in flight) is what the reference charges, so its
    record carries both."""
    c = hlo_bytes.Collective
    node = tuple(range(16, 32))  # 16 ranks over 2 nodes
    return [c("all-gather", 16, 256 * 1024 * BF16, node),
            c("all-reduce", 16, 1024 * 1024 * F32, node),
            c("reduce-scatter", 16, 1024 * 1024 * F32, node),
            c("all-to-all", 16, 512 * 64 * BF16, node),
            c("collective-permute", 16, 128 * 4, node),
            c("collective-permute", 16, 2 * 16 * 16 * F32, node)]


def test_wire_model_matches_reference_op_by_op():
    want = jroofline.collective_bytes(HLO, n_shards=16)
    got = roofline.collective_bytes(_records())
    assert got.counts == want.counts
    assert set(got.by_op) == set(want.by_op)
    for op in want.by_op:
        assert got.by_op[op] == pytest.approx(want.by_op[op], rel=1e-12), op
    assert got.wire_bytes == pytest.approx(want.wire_bytes, rel=1e-12)
    assert got.seconds == pytest.approx(got.wire_bytes / roofline.NET_BW)


def test_links_by_mesh_axis():
    mesh = [[r * 16 + c for c in range(16)] for r in range(16)]  # (16, 16), "model" inner
    model_group, data_group = mesh[3], [row[5] for row in mesh]
    assert roofline.link_bw(model_group) == roofline.NET_BW       # 16 ranks span 2 nodes
    assert roofline.link_bw(data_group) == roofline.NET_BW        # stride 16: a node each
    assert roofline.link_bw(range(8, 16)) == roofline.NVLINK_BW   # one node
    assert roofline.link_bw(range(4, 12)) == roofline.NET_BW
    assert roofline.link_bw(()) == roofline.NVLINK_BW


def test_roofline_terms_on_h100_constants():
    rl = roofline.Roofline(
        name="t", chips=256,
        hlo_flops_per_device=989e12 + 67e12,
        hlo_bytes_per_device=3.35e12 * 3,         # 3 s of memory
        wire_bytes_per_device=50e9,
        model_flops_total=989e12 * 256 * 0.75,
        collectives={}, collective_counts={}, memory_per_device={},
        flops_by_dtype={"bfloat16": 989e12, "float32": 67e12},  # 1 s + 1 s
        collective_s=0.5)
    assert rl.t_compute == pytest.approx(2.0)
    assert rl.t_memory == pytest.approx(3.0)
    assert rl.t_collective == pytest.approx(0.5)
    assert rl.bottleneck == "memory" and rl.t_bound == pytest.approx(3.0)
    assert rl.roofline_fraction == pytest.approx(0.25)
    assert rl.useful_flops_ratio == pytest.approx(0.75 * 989 / (989 + 67))
    d = rl.to_dict()
    for key in ("name", "chips", "hlo_flops_per_device", "hlo_bytes_per_device",
                "wire_bytes_per_device", "model_flops_total", "t_compute_s", "t_memory_s",
                "t_collective_s", "bottleneck", "useful_flops_ratio", "roofline_fraction",
                "collectives", "collective_counts", "memory_per_device",
                "raw_cost_bytes_per_device"):
        assert key in d, key  # the reference's record fields, every one
    # no dtype split and no group: the bf16 peak and the network
    plain = roofline.Roofline("u", 1, 989e12, 0.0, 50e9, 0.0, {}, {}, {})
    assert plain.t_compute == pytest.approx(1.0) and plain.t_collective == pytest.approx(1.0)


def test_analyze_scales_a_unit():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    with hlo_bytes.Counter() as c:
        a @ b
    c.collectives.append(hlo_bytes.Collective("all-reduce", 2, 100.0, (0, 1)))
    rl = roofline.analyze("x", c, 2, 1e3, hlo_scale=3)
    assert rl.hlo_flops_per_device == 3 * 2 * 8 * 16 * 4
    assert rl.hlo_bytes_per_device == 3 * (8 * 16 + 16 * 4 + 8 * 4) * F32
    assert rl.wire_bytes_per_device == pytest.approx(3 * 100.0)
    assert rl.collective_counts == {"all-reduce": 3}
    assert rl.t_collective == pytest.approx(300.0 / roofline.NVLINK_BW)


def test_counter_matmul_cast_view_inplace_copy():
    m, k, n = 8, 32, 16
    a, b = torch.randn(m, k), torch.randn(k, n)
    with hlo_bytes.Counter() as c:
        a @ b
    assert c.flops == 2 * m * k * n
    assert c.bytes == (m * k + k * n + m * n) * F32
    assert dict(c.flops_by_dtype) == {"float32": 2 * m * k * n}

    with hlo_bytes.Counter() as c:
        a.to(torch.bfloat16)  # a real pass on the card: counted
    assert c.flops == 0 and c.bytes == m * k * (F32 + BF16)

    x = torch.randn(4, 6, 8)
    with hlo_bytes.Counter() as c:
        x.view(24, 8)
        x.reshape(4, 48)        # a view
        torch.ops.aten._unsafe_view(x, (24, 8))
        x.expand(2, 4, 6, 8)
        x.permute(2, 0, 1)
        x.transpose(0, 1)
        x[0].t()
        x[:, 1:3]
        x.select(1, 2)
        x.as_strided((4, 6), (48, 8))
        x.detach()
        torch.ops.aten.alias(x)
        torch.empty(4, 8)
    assert c.bytes == 0 and c.flops == 0 and not c.calls

    y = torch.randn(4, 6, 8)
    with hlo_bytes.Counter() as c:
        x.add_(y)  # reads both, writes x
        x.copy_(y)  # reads y, writes x
    assert c.by_kind["aten.add_"] == 3 * x.numel() * F32
    assert c.by_kind["aten.copy_"] == 2 * x.numel() * F32
    assert c.bytes == 5 * x.numel() * F32

    with hlo_bytes.Counter() as c:
        x.transpose(0, 1).contiguous()  # a copying reshape is a pass
    assert c.bytes == 2 * x.numel() * F32


@pytest.mark.parametrize("causal", [False, True])
def test_flash_call_counted_at_the_kernel_formula(causal):
    g = torch.Generator().manual_seed(0)
    b, h, sq, sk, d = 2, 3, 5, 7, 16
    q = torch.randn(b, h, sq, d, generator=g)
    k, v = (torch.randn(b, h, sk, d, generator=g) for _ in range(2))
    bias = torch.randn(b, sk, generator=g)
    with hlo_bytes.Counter() as c:
        out = ops.flash_attention(q, k, v, bias=bias, causal=causal)
    pairs = sum(i + sk - sq + 1 for i in range(sq)) if causal else sq * sk
    assert c.flops == 4 * b * h * d * pairs
    assert c.bytes == (q.numel() + k.numel() + v.numel() + out.numel() + bias.numel()) * F32
    assert dict(c.count) == {"kernel.flash_attention": 1}  # nothing inside counted
    assert dict(c.kernels) == {"flash_attention": 1}


def test_tome_and_decode_calls_counted_at_the_kernel_formula():
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(2, 9, 16, generator=g), torch.randn(2, 8, 16, generator=g)
    q = torch.randn(3, 4, 32, generator=g)
    kc, vc = (torch.randn(3, 10, 2, 32, generator=g) for _ in range(2))
    lengths = torch.tensor([10, 4, 7], dtype=torch.int32)
    with hlo_bytes.Counter() as c:
        ops.tome_scores(a, b)
        ops.decode_attention(q, kc, vc, lengths)
    assert c.by_kind["kernel.tome_scores"] == (a.numel() + b.numel()) * F32 + 2 * 9 * 8
    assert c.by_kind["kernel.decode_attention"] == (
        (2 * q.numel() + kc.numel() + vc.numel()) * F32 + 3 * 4)
    assert c.flops == 2 * 2 * 9 * 8 * 16 + 4 * 3 * 4 * 10 * 32
    assert dict(c.count) == {"kernel.tome_scores": 1, "kernel.decode_attention": 1}


def test_kernel_scope_without_a_counter_costs_nothing():
    def cost():
        raise AssertionError("evaluated without a counter")
    assert hlo_bytes.kernel("flash_attention", cost, lambda: 7) == 7


def test_flash_backward_is_counted_as_the_card_runs_it():
    q, k, v = (torch.randn(1, 2, 6, 16, requires_grad=True) for _ in range(3))
    with hlo_bytes.Counter() as c:
        out = ops.flash_attention(q, k, v)
        out.sum().backward()
    assert c.kernels["flash_attention"] == 1
    # the backward's five products at 2*D a pair each
    assert c.flops - 4 * 2 * 16 * 36 == 5 * 2 * 1 * 2 * 36 * 16
    assert c.kernels["flash_attention_bwd"] == 1


def test_hloprof_report_and_flags():
    x = torch.randn(64, 64)
    with hlo_bytes.Counter() as c:
        y = x @ x
        (y + 1).to(torch.bfloat16)
    by_kind, counts, heavy = hloprof.profile_calls(c.calls, top=2)
    assert list(by_kind) == ["aten.mm", "aten.add", "aten._to_copy"]
    assert counts == {"aten.mm": 1, "aten.add": 1, "aten._to_copy": 1}
    assert heavy[0][0] == 3 * 64 * 64 * F32 and "aten.mm" in heavy[0][1]
    text = hloprof.report(c)
    assert "bytes by op kind:" in text and "heaviest calls:" in text
    with flags.unrolled_costs():
        assert flags.layer_unroll(30) == 30
    assert flags.layer_unroll(7) == 7


def test_peak_memory_of_live_tensors():
    x = torch.randn(256, 256)
    with hlo_bytes.Counter(memory=True) as c:
        c.track(x)
        y = x @ x          # +256 KB
        z = y + 1          # +256 KB
        del y
        w = z * 2          # +256 KB, y freed
        q = torch.randn(1, 2, 8, 16)
        out = ops.flash_attention(q, q, q)  # the kernel's output, not its plain scores
    n = 256 * 256 * F32
    assert c.peak_bytes == 3 * n + q.numel() * F32 * 2 and w.shape == z.shape
    assert c.live_bytes == c.peak_bytes and out.shape == q.shape
