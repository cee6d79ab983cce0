"""Launch plans of the flash-attention and SSD-scan wrappers, on the CPU.

``plan`` is pure Python: it picks a kernel design from the dtype, the
widths and the alignment, and sizes the block as ``csrc/*.cu`` does
(``tests/test_torch_cuda.py`` holds the two against each other on the
card).  Here: every shape the wrappers take gets a plan within the
232,448 bytes of shared memory a Hopper block may have; the full-width
embedders' own inputs, with their real strides (recorded on the meta
device, nothing allocated), take the tensor-core designs; float32 always
takes the CUDA-core ones.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.models.attention import Attention
from repro_torch.models.ssm import SSM

SMEM = 232_448
DTYPES = [torch.float32, torch.bfloat16]
LENGTHS = [1, 63, 64, 65, 300, 4096, 32768]


def _strides(*ts):
    return [s for t in ts for s in t.stride()]


def _aligned(*ts):
    """Whether each tensor's first element is 16-byte aligned, given an
    aligned allocation (what data_ptr() % 16 tells on the card)."""
    return all(t.storage_offset() * t.element_size() % 16 == 0 for t in ts)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plan_fits_every_head_width_and_length(dtype):
    for dh in range(4, kfa.MAX_DH + 1, 4):
        for S in LENGTHS:
            p = kfa.plan(dtype, dh, S, strides=[dh * 8, dh, dh] * 4)
            tc = dtype == torch.bfloat16 and dh % 16 == 0
            assert p.design == ("tensor_core" if tc else "cuda_core"), dh
            assert 0 < p.smem_bytes <= SMEM, (dh, p)
            assert -(-S // p.block_rows) <= kfa.MAX_ROW_TILES
            if tc:
                assert p.block_rows == 64 and p.key_tile in (32, 64)
                assert 2 * (p.smem_bytes + 1024) <= 233_472, (
                    "two tensor-core blocks must fit an SM", dh, p)


@pytest.mark.parametrize("dh", [0, 2, 6, 130, 260, 512])
def test_flash_plan_refuses_what_no_design_takes(dh):
    with pytest.raises(ValueError, match="head width"):
        kfa.plan(torch.bfloat16, dh, 128)


@pytest.mark.parametrize("strides,aligned", [
    ([256 * 128, 256, 255] + [256] * 9, True),   # a row not 16-byte aligned
    ([256 * 128, 256, 256] * 4, False),          # a pointer off by 2 bytes
])
def test_flash_plan_unaligned_bf16_takes_cuda_cores(strides, aligned):
    assert kfa.plan(torch.bfloat16, 256, 128, strides=strides,
                    aligned=aligned).design == "cuda_core"
    assert kfa.plan(torch.bfloat16, 256, 128).design == "tensor_core"


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_plan_fits_every_head_and_state_width(dtype):
    accepted = 0
    for P in range(1, kssd.MAX_P + 1):
        for N in range(1, 257):
            y = [P * 24 * 1024, P * 24, P, 1]
            try:
                p = kssd.plan(dtype, P, N, strides=y * 4)
            except ValueError as e:
                # refused only where the float32 design's tiles cannot
                # fit, as before the tensor-core design existed
                assert "shared memory" in str(e)
                assert kssd.cuda_core_smem_bytes(P, N) > SMEM
                continue
            accepted += 1
            assert 0 < p.smem_bytes <= SMEM, (P, N, p)
            assert p.chunk == kssd.CHUNK
            tc = (dtype == torch.bfloat16 and P % 16 == 0 and N % 16 == 0
                  and P <= 64 and N <= 128)
            assert p.design == ("tensor_core" if tc else "cuda_core"), (P, N)
            if tc:
                assert 2 * (p.smem_bytes + 1024) <= 233_472, (
                    "two tensor-core blocks must fit an SM", P, N, p)
    # every width up to mamba2's and every state up to 256 at P <= 64
    assert accepted >= 64 * 256


def test_ssd_plan_non_unit_rows_or_unaligned_take_cuda_cores():
    good = [1024 * 1792, 1792, 64, 1] * 4
    assert kssd.plan(torch.bfloat16, 64, 128,
                     strides=good).design == "tensor_core"
    odd_row = good[:4] + [1024 * 1792, 1792, 64, 2] + good[8:]
    assert kssd.plan(torch.bfloat16, 64, 128,
                     strides=odd_row).design == "cuda_core"
    odd_step = [1024 * 1790, 1790, 64, 1] + good[4:]
    assert kssd.plan(torch.bfloat16, 64, 128,
                     strides=odd_step).design == "cuda_core"
    assert kssd.plan(torch.bfloat16, 64, 128, strides=good,
                     aligned=False).design == "cuda_core"
    with pytest.raises(ValueError, match="head width"):
        kssd.plan(torch.bfloat16, 130, 128)


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' arguments, recorded where ops calls them."""
    seen = {}

    def rec(name):
        def fn(*a, **kw):
            seen[name] = a
            return torch.empty_like(a[0])
        return fn
    monkeypatch.setattr(ops, "flash_attention_cuda", rec("flash"))
    monkeypatch.setattr(ops, "ssd_scan_cuda", rec("ssd"))
    return seen


def test_gemma_7b_full_width_attention_takes_tensor_cores(recorded):
    """One layer of a 64 x 128-token batch at gemma-7b's width: q and k
    after RoPE, v a view of its (B, S, H, dh) projection."""
    cfg = get_config("gemma-7b")
    layer = Attention(cfg, device="meta")
    layer(torch.empty((64, 128, cfg.d_model), dtype=cfg.cdtype,
                      device="meta"))
    q, k, v = recorded["flash"]
    assert q.shape == (64, 16, 128, 256) and q.dtype == torch.bfloat16
    assert v.stride() == (128 * 4096, 256, 4096, 1)      # a strided view
    o = torch.empty_like(q)
    p = kfa.plan(q.dtype, q.shape[-1], q.shape[2],
                 strides=[s for t in (q, k, v, o) for s in t.stride()[:3]],
                 aligned=_aligned(q, k, v, o))
    assert p == kfa.Plan("tensor_core", 64, 32, (64 + 4 * 32) * 264 * 2)
    assert p.smem_bytes == 101_376


def test_mamba2_130m_full_width_scan_takes_tensor_cores(recorded):
    """One block of a 64 x 1,024-token batch at mamba2-130m's width: x, B
    and C are views of one (B, S, 1792) conv output, B and C at element
    offsets 1,536 and 1,664."""
    cfg = get_config("mamba2-130m")
    block = SSM(cfg, device="meta")
    block(torch.empty((64, 1024, cfg.d_model), dtype=cfg.cdtype,
                      device="meta"))
    x, a_log, b, c, dt = recorded["ssd"]
    assert x.shape == (64, 1024, 24, 64) and b.shape == (64, 1024, 1, 128)
    assert x.stride()[1] == b.stride()[1] == c.stride()[1] == 1792
    assert (b.storage_offset(), c.storage_offset()) == (1536, 1664)
    y = torch.empty(x.shape, dtype=x.dtype, device="meta")
    p = kssd.plan(x.dtype, 64, 128, strides=_strides(x, b, c, y),
                  aligned=_aligned(x, b, c, y))
    assert p == kssd.Plan("tensor_core", 64, 128, 108_032)


@pytest.mark.parametrize("arch", ["gemma-7b", "mamba2-130m"])
def test_float32_always_takes_cuda_cores(arch, recorded):
    """The reduced (float32) configs, as the card's model tests run them."""
    cfg = get_config(arch, reduced=True)
    assert cfg.cdtype == torch.float32
    if arch == "gemma-7b":
        Attention(cfg, device="meta")(
            torch.empty((3, 100, cfg.d_model), device="meta"))
        q, k, v = recorded["flash"]
        p = kfa.plan(q.dtype, q.shape[-1], q.shape[2],
                     strides=[s for t in (q, k, v) for s in t.stride()[:3]])
    else:
        SSM(cfg, device="meta")(
            torch.empty((3, 300, cfg.d_model), device="meta"))
        x, _, b, c, _ = recorded["ssd"]
        p = kssd.plan(x.dtype, x.shape[-1], b.shape[-1],
                      strides=_strides(x, b, c, x))
    assert p.design == "cuda_core"


def test_launch_counts_start_at_zero_per_design():
    for mod, fn in ((kfa, kfa.flash_attention_cuda),
                    (kssd, kssd.ssd_scan_cuda)):
        fn.launches_by_design["tensor_core"] += 3
        fn.launches += 3
        mod.reset_launches()
        assert fn.launches == 0
        assert fn.launches_by_design == {"tensor_core": 0, "cuda_core": 0}


def test_cpu_tensors_run_the_plain_versions_and_launch_nothing():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, 16, 32), generator=g).bfloat16()
    before = dict(kfa.flash_attention_cuda.launches_by_design)
    out = kfa.flash_attention_cuda(q, q, q)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert kfa.flash_attention_cuda.launches_by_design == before
    x = torch.randn((1, 70, 2, 16), generator=g).bfloat16()
    bc = torch.randn((1, 70, 1, 16), generator=g).bfloat16()
    dt = torch.rand((1, 70, 2), generator=g)
    before = dict(kssd.ssd_scan_cuda.launches_by_design)
    y = kssd.ssd_scan_cuda(x, torch.zeros(2), bc, bc, dt)
    assert y.shape == x.shape and torch.isfinite(y.float()).all()
    assert kssd.ssd_scan_cuda.launches_by_design == before
