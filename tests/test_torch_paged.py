"""The paged decode kernel's split plan and its plain version on the CPU.

The plain version cuts the page table into splits of ``pages_per_split``
pages, forms each split's softmax partial page by page and combines the
splits by their log-sum-exp, as ``csrc/paged_decode.cu`` does on the card.
Here it is held against the reference's Pallas paged kernel in interpret
mode, for bf16 and int8 pools at GQA groups of 1, 4 and 8, over lengths at
every split edge; one split is held against the single page-by-page pass
bit for bit; and the plan is checked to cut whole pages from shapes alone
and to fill the card at the shapes the serving path and ``chip_smoke.py``
give it.

Tolerances (as ``tests/test_torch_kernels.py``'s paged test): both sides
sum f32 products, in other orders; a bf16 output may round one bf16 ulp
apart (atol 1e-2 at unit-scale outputs), an f32 output of the int8 pool
agrees within 1e-5."""
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import ops as pt_ops  # noqa: E402
from repro_torch.kernels import paged_attention as pt_paged  # noqa: E402

HKV, D, PAGE, MP = 2, 32, 8, 8
# every edge of the splits of 1, 2 and 4 pages (8, 16 and 32 tokens) at
# distance 1, one live token, and a full table
LENGTHS = (1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64)
SPLITS = (1, 2, 4, MP)


def _inputs(form: str, G: int, seed: int = 0):
    """q (B, G * HKV, D), pools (P, PAGE, HKV, D) (int8 with scales, or
    f32 values to cast to bf16), a page table of distinct pages (unmapped
    columns on trash page 0) and LENGTHS, as numpy arrays."""
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    P = B * MP + 1
    q = rng.normal(size=(B, G * HKV, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, P)).reshape(B, MP)
    pt = np.zeros((B, MP), np.int32)
    for b, n in enumerate(LENGTHS):
        pt[b, :-(-n // PAGE)] = perm[b, :-(-n // PAGE)]
    lens = np.asarray(LENGTHS, np.int32)
    if form == "int8":
        k = rng.integers(-127, 127, (P, PAGE, HKV, D)).astype(np.int8)
        v = rng.integers(-127, 127, (P, PAGE, HKV, D)).astype(np.int8)
        ks = rng.uniform(0.01, 0.02, (P, PAGE, HKV)).astype(np.float32)
        vs = rng.uniform(0.01, 0.02, (P, PAGE, HKV)).astype(np.float32)
        return q, k, v, pt, lens, ks, vs
    k = rng.normal(size=(P, PAGE, HKV, D)).astype(np.float32)
    v = rng.normal(size=(P, PAGE, HKV, D)).astype(np.float32)
    return q, k, v, pt, lens, None, None


def _torch_args(form: str, arrays):
    """The arrays as the port takes them: bf16 q and pool for ``bf16``,
    f32 q with the int8 pool for ``int8``, ``f32`` all f32."""
    q, k, v, pt, lens, ks, vs = arrays
    fdt = torch.bfloat16 if form == "bf16" else torch.float32
    t = torch.from_numpy
    kv = (t(k), t(v)) if form == "int8" else (t(k).to(fdt), t(v).to(fdt))
    return (t(q).to(fdt), *kv, t(pt), t(lens),
            None if ks is None else t(ks), None if vs is None else t(vs))


@functools.lru_cache(maxsize=None)
def _pallas(form: str, G: int) -> np.ndarray:
    """The reference's Pallas paged kernel (interpret mode) on
    ``_inputs(form, G)``, in f32."""
    q, k, v, pt, lens, ks, vs = _inputs(form, G)
    jdt = jnp.bfloat16 if form == "bf16" else jnp.float32
    jk = jnp.asarray(k) if form == "int8" else jnp.asarray(k, jdt)
    jv = jnp.asarray(v) if form == "int8" else jnp.asarray(v, jdt)
    out = ref_ops.paged_flash_decode(
        jnp.asarray(q, jdt), jk, jv, jnp.asarray(pt), jnp.asarray(lens),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("pps", SPLITS)
@pytest.mark.parametrize("G", (1, 4, 8))
@pytest.mark.parametrize("form", ("bf16", "int8"))
def test_split_plain_matches_pallas(form, G, pps):
    got = pt_paged.paged_flash_decode_plain(
        *_torch_args(form, _inputs(form, G)), pages_per_split=pps)
    assert got.dtype == (torch.bfloat16 if form == "bf16" else torch.float32)
    atol = 1e-2 if form == "bf16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), _pallas(form, G),
                               atol=atol)


def _single_pass(q, k_pages, v_pages, page_table, lengths, k_scale=None,
                 v_scale=None):
    """The page-by-page online softmax over the whole table in one pass
    (the plain version before the split), written out here as the
    one-split case's yardstick."""
    B, H, Dh = q.shape
    _, page, Hkv, _ = k_pages.shape
    G = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Hkv, G, Dh).float()
    m = torch.full((B, Hkv, G), pt_paged.NEG_INF)
    l = torch.zeros((B, Hkv, G))
    acc = torch.zeros((B, Hkv, G, Dh))
    pt, lens = page_table.long(), lengths.long()
    for j in range(pt.shape[1]):
        phys = pt[:, j]
        k = k_pages[phys].float()
        v = v_pages[phys].float()
        if k_scale is not None:
            k = k * k_scale[phys][..., None]
            v = v * v_scale[phys][..., None]
        s = torch.einsum("bkgd,btkd->bkgt", qg, k) * scale
        kpos = j * page + torch.arange(page)
        mask = (kpos[None, :] < lens[:, None])[:, None, None, :]
        s = torch.where(mask, s, pt_paged.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgt,btkd->bkgd", p, v)
        m = m_new
    safe = torch.where(l == 0.0, 1.0, l)
    return (acc / safe[..., None]).reshape(B, H, Dh).to(q.dtype)


@pytest.mark.parametrize("form", ("bf16", "int8", "f32"))
def test_one_split_is_the_single_pass_bit_for_bit(form):
    args = _torch_args(form, _inputs("int8" if form == "int8" else "f32",
                                     4, seed=1))
    got = pt_paged.paged_flash_decode_plain(*args, pages_per_split=MP)
    assert torch.equal(got, _single_pass(*args))


@pytest.mark.parametrize("pps", (1, 2, MP))
def test_splits_ignore_trash_and_unmapped_pages(pps):
    """Page 0 (trash), the pages no table maps and the tokens past each
    length in a slot's last page may hold anything: the output does not
    move by a bit, whatever the split."""
    args = _torch_args("f32", _inputs("f32", 4, seed=2))
    k, v, pt = args[1], args[2], args[3]
    out1 = pt_paged.paged_flash_decode_plain(*args, pages_per_split=pps)
    k2, v2 = k.clone(), v.clone()
    mapped = set(pt.flatten().tolist()) - {0}
    for p in range(k.shape[0]):
        if p not in mapped:
            k2[p] = 7.0 * k2[p] + 3.0
            v2[p] = -3.0 * v2[p] + 1.0
    for b, n in enumerate(LENGTHS):
        if n % PAGE:
            p = int(pt[b, n // PAGE])
            k2[p, n % PAGE:] = 1e4
            v2[p, n % PAGE:] = -1e4
    out2 = pt_paged.paged_flash_decode_plain(args[0], k2, v2, *args[3:],
                                             pages_per_split=pps)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)


def test_cpu_wrapper_takes_the_plan():
    """``ops.paged_flash_decode`` on CPU tensors is the plain version at
    the kernel's plan, and counts no launch."""
    pt_ops.reset_launches()
    args = _torch_args("int8", _inputs("int8", 4, seed=3))
    pps, _ = pt_paged.paged_decode_plan(len(LENGTHS), HKV, MP, PAGE)
    got = pt_ops.paged_flash_decode(*args)
    assert torch.equal(got, pt_paged.paged_flash_decode_plain(
        *args, pages_per_split=pps))
    assert all(n == 0 for n in pt_ops.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(B, Hkv, mp, page)
               for B in (1, 3, 4, 8, 32) for Hkv in (1, 2, 8)
               for mp in (1, 2, 5, 16, 17, 64, 128, 2048)
               for page in (8, 16, 32)]


def test_plan_cuts_the_table_into_whole_pages():
    """Over slots, kv heads, table widths and page sizes: whole pages a
    split, no split beyond the table, and the splits cover it."""
    for B, Hkv, mp, page in PLAN_SHAPES:
        pps, nsplit = pt_paged.paged_decode_plan(B, Hkv, mp, page)
        assert type(pps) is int and type(nsplit) is int
        assert 1 <= pps <= mp and 1 <= nsplit <= mp
        assert (nsplit - 1) * pps < mp <= nsplit * pps


@pytest.mark.parametrize("mp", (16, 32, 64, 128))
def test_plan_fills_the_card_at_serving_and_check_shapes(mp):
    """4 slots x 8 kv heads (qwen3-4b serving, and ``chip_smoke.py``'s
    ``check_paged`` at 128 pages): at least 66 CTAs, half the H100's 132
    SMs, at every page view the engine hands the kernel."""
    pps, nsplit = pt_paged.paged_decode_plan(4, 8, mp, 16)
    assert 4 * 8 * nsplit >= 66


def test_plan_takes_shape_ints_only():
    """A device value (a length, a tensor) is refused: reading it would
    wait for the card."""
    with pytest.raises(TypeError):
        pt_paged.paged_decode_plan(4, 8, torch.tensor(128), 16)
    with pytest.raises(TypeError):
        pt_paged.paged_decode_plan(4, 8, 128.0, 16)
