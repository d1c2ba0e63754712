"""The blocking of the bf16 physics kernels
(``tactilesr_torch/ops/cuda/tpsf_kernel.cu``: ``tpsf_physics_bf16_kernel``,
``physics_precision: default``, and ``tpsf_physics_bf16x3_kernel``,
``physics_precision: high``, one body ``tpsf_physics_bf16_tiled<PLANES>``),
modelled in plain PyTorch on the CPU.

The kernels cannot run here, so this file keeps a model of their
arithmetic (not in the package) and holds it against the plain version
``physics_plain(depth, abm, precision)``.  Each operand x of a product is
split into ``planes`` bf16 planes: hi = bf16(x) at ``default``, and also
lo = bf16(x - hi) at ``high``, where a product is hi . hi + hi . lo +
lo . hi in f32 (lo . lo dropped):

- A(beta) is built from nine 16x16 Toeplitz tiles a plane (block offsets
  -4..4), so A's padded rows and columns (100..111) hold taps, not zeros,
  in every plane; D's planes are padded to 112 with zeros;
- T = A . D is an f32 sum, split into planes as the next product's operand;
- the epilogue reads only i, j < 100: the second max over the non-contact
  HR0 with the contact pixels' zeros as its floor, and
  sum(HR) = sum of the non-contact HR0 + count * second;
- V = U . HR (both split) is the sum of the seven 16-row stripes'
  partials, taken in stripe order, and LR = (V . U^T, both split, -
  mn sum(HR)) / (1 - mn) 1e-4.

The model and the plain version compute the same function with f32 sums
in other orders, so they agree within 1e-5 of the largest |HR| and |LR|.
The all-zero map gives exactly zero HR and LR.
"""

import numpy as np
import pytest
import torch

from tactilesr_torch.ops.psf import (
    C_MASK, C_PSF, DEGRADE_SCALE, DISTURBANCE, HR_SIZE, TAXEL_CENTER_0, TAXEL_PITCH, TAXELS,
    physics_plain,
)

MP = 112  # the kernel's padded map
BLK = 16  # an mma tile's rows and depth
MT = MP // BLK  # seven stripes
BAND_TILES = 4  # A's 16x16 blocks more than 4 apart are zero
REL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


PRECISIONS = ("default", "high")
PLANES = {"default": 1, "high": 2}


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _split(x, planes):
    """x as its bf16 planes: [hi], or [hi, lo] with lo = bf16(x - hi)."""
    hi = _bf16(x)
    return [hi] if planes == 1 else [hi, _bf16(x - hi)]


def _dot(a, b):
    """A product of split operands (lists of planes): hi . hi, and with two
    planes + hi . lo + lo . hi, summed in that order."""
    out = torch.matmul(a[0], b[0])
    if len(a) == 2:
        out = out + torch.matmul(a[0], b[1]) + torch.matmul(a[1], b[0])
    return out


def _taps(beta):
    """(B,) beta -> (B, 9, 16, 16) in f32: tile t (block offset o = t - 4)
    holds g(16 o + c - r) at (r, c), g(d) = exp(-C_PSF d^2 / beta^2) for
    |d| <= 49, else 0 (the kernel's gpad)."""
    o = torch.arange(-BAND_TILES, BAND_TILES + 1)[:, None, None]
    d = (BLK * o + torch.arange(BLK)[None, None, :] - torch.arange(BLK)[None, :, None]).float()
    b = beta.reshape(-1, 1, 1, 1)
    g = torch.exp(-C_PSF * d ** 2 / (b * b))
    return torch.where(d.abs() <= 49, g, torch.zeros(()))


def _a_from_tiles(tiles):
    """(B, 9, 16, 16) -> the padded A (B, 112, 112) as the kernel reads it:
    block (mt, kt) is tile kt - mt, zero beyond the band; the padding holds
    taps."""
    a = torch.zeros(tiles.shape[0], MP, MP)
    for mt in range(MT):
        for kt in range(MT):
            if abs(kt - mt) <= BAND_TILES:
                a[:, BLK * mt:BLK * (mt + 1), BLK * kt:BLK * (kt + 1)] = tiles[:, kt - mt + BAND_TILES]
    return a


def _at_from_tiles(tiles):
    """A^T's padded blocks as product 2 reads them: block (kt, np) is tile
    kt - np read as stored (n x k), i.e. transposed into (k, n)."""
    at = torch.zeros(tiles.shape[0], MP, MP)
    for kt in range(MT):
        for np_ in range(MT):
            if abs(kt - np_) <= BAND_TILES:
                at[:, BLK * kt:BLK * (kt + 1), BLK * np_:BLK * (np_ + 1)] = \
                    tiles[:, kt - np_ + BAND_TILES].transpose(-2, -1)
    return at


def _u(m):
    """(B,) m -> U (B, 4, 100) in f32."""
    x = torch.arange(HR_SIZE, dtype=torch.float32)
    c = torch.arange(TAXELS, dtype=torch.float32)[:, None] * TAXEL_PITCH + TAXEL_CENTER_0
    return torch.exp(-C_MASK * (x - c) ** 2 / m.reshape(-1, 1, 1))


def _pad(x, rows, cols):
    """x zero-padded at the bottom and right to (rows, cols)."""
    out = torch.zeros(*x.shape[:-2], rows, cols)
    out[..., :x.shape[-2], :x.shape[-1]] = x
    return out


def kernel_model(depth, abm, planes=1):
    """The kernel's arithmetic with ``planes`` bf16 planes per operand:
    depth (B,100,100), abm (B,3) -> (HR, LR, T's planes (B, planes, 112,
    112), f32 of bf16 values)."""
    depth = depth.float()
    alpha, beta, m = abm[:, 0].reshape(-1, 1, 1), abm[:, 1], abm[:, 2]
    tiles = _split(_taps(beta), planes)  # each plane's tiles: taps in A's padding
    d = [_pad(p, MP, MP) for p in _split(depth, planes)]  # zero padding in every plane
    t = _split(_dot([_a_from_tiles(p) for p in tiles], d), planes)
    hr0 = (alpha * _dot(t, [_at_from_tiles(p) for p in tiles]))[:, :HR_SIZE, :HR_SIZE]
    mx = depth.amax(dim=(-2, -1), keepdim=True)
    contact = depth > mx - DISTURBANCE
    zero = torch.zeros(())
    non_contact = torch.where(contact, zero, hr0)
    second = non_contact.amax(dim=(-2, -1), keepdim=True).clamp_min(0.0)
    count = contact.sum(dim=(-2, -1), keepdim=True).float()
    hsum = non_contact.sum(dim=(-2, -1), keepdim=True) + count * second
    hr = torch.where(contact, second, hr0)
    u = _split(_u(m), planes)
    up = [_pad(p, TAXELS, MP) for p in u]
    hp = [_pad(p, MP, MP) for p in _split(hr, planes)]
    v = torch.zeros(depth.shape[0], TAXELS, MP)
    for w in range(MT):  # the stripes' partials, in stripe order
        rows = slice(BLK * w, BLK * (w + 1))
        v = v + _dot([p[:, :, rows] for p in up], [p[:, rows, :] for p in hp])
    mn = torch.exp(-100.0 / m).reshape(-1, 1, 1)
    t2 = _dot(_split(v[:, :, :HR_SIZE], planes), [p.transpose(-2, -1) for p in u])
    lr = (t2 - mn * hsum) / (1.0 - mn) * DEGRADE_SCALE
    return hr, lr, torch.stack(t, 1)


def _rects(rng, b):
    depth = np.zeros((b, HR_SIZE, HR_SIZE), np.float32)
    for k in range(b):
        r0, c0 = rng.integers(10, 45, 2)
        r1, c1 = rng.integers(55, 95, 2)
        depth[k, r0:r1, c0:c1] = 1.0
    depth[::2] += 0.05 * rng.standard_normal(depth[::2].shape).astype(np.float32)
    return depth


def _abm(rng, b, beta=None):
    abm = (0.5 + np.abs(rng.standard_normal((b, 3)))).astype(np.float32)
    if beta is not None:
        abm[:, 1] = beta
    return abm


CASES = ["rects", "border", "all_contact", "beta_small", "beta_large"]


def _case(name):
    """(depth, abm) of a named case, made from a seed with numpy."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "rects":
        depth, abm = _rects(rng, 4), _abm(rng, 4)
    elif name == "border":  # contacts on rows and columns 0 and 99, noise below them
        depth = 0.3 * rng.random((4, HR_SIZE, HR_SIZE)).astype(np.float32)
        depth[0, 0, :] = depth[0, -1, :] = 1.0
        depth[1, :, 0] = depth[1, :, -1] = 1.0
        depth[2, 0, 0] = depth[2, 0, -1] = depth[2, -1, 0] = depth[2, -1, -1] = 1.0
        depth[3, [0, -1], :] = 1.0
        depth[3, :, [0, -1]] = 1.0
        abm = _abm(rng, 4)
    elif name == "all_contact":  # every pixel within the disturbance of the max
        depth = np.full((3, HR_SIZE, HR_SIZE), 0.7, np.float32)
        depth[1] = 2.0
        depth[2] += 4e-4 * rng.random((HR_SIZE, HR_SIZE)).astype(np.float32)
        abm = _abm(rng, 3)
    elif name == "beta_small":  # the tiles at +-1..4 carry (almost) nothing
        depth, abm = _rects(rng, 3), _abm(rng, 3, beta=0.05)
    elif name == "beta_large":  # the tiles at +-4 carry g(+-49)
        depth, abm = _rects(rng, 3), _abm(rng, 3, beta=50.0)
    else:
        raise KeyError(name)
    return torch.from_numpy(depth), torch.from_numpy(abm)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name", ["rects", "border", "beta_small", "beta_large"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_model_matches_plain(precision, name):
    depth, abm = _case(name)
    hr, lr, _ = kernel_model(depth, abm, PLANES[precision])
    hr_p, lr_p = physics_plain(depth, abm, precision)
    assert torch.isfinite(hr).all() and torch.isfinite(lr).all()
    assert _rel(hr, hr_p) < REL and _rel(lr, lr_p) < REL, (_rel(hr, hr_p), _rel(lr, lr_p))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_all_contact_map_has_second_max_zero(precision):
    """Every pixel in contact: the second max is its floor 0, so HR and LR
    are zero, in the model as in the plain version."""
    depth, abm = _case("all_contact")
    hr, lr, _ = kernel_model(depth, abm, PLANES[precision])
    hr_p, lr_p = physics_plain(depth, abm, precision)
    assert torch.equal(hr, torch.zeros_like(hr)) and torch.equal(hr_p, torch.zeros_like(hr_p))
    assert float(lr.abs().max()) == 0.0 and float(lr_p.abs().max()) == 0.0


@pytest.mark.parametrize("precision", PRECISIONS)
def test_all_zero_map_gives_exact_zeros(precision):
    depth = torch.zeros(2, HR_SIZE, HR_SIZE)
    abm = torch.from_numpy(_abm(np.random.default_rng(7), 2))
    hr, lr, t = kernel_model(depth, abm, PLANES[precision])
    assert t.shape == (2, PLANES[precision], MP, MP)
    assert torch.equal(t, torch.zeros_like(t))
    assert torch.equal(hr, torch.zeros_like(hr)) and torch.equal(lr, torch.zeros_like(lr))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_padding_holds_taps_and_the_map_stays_exact(precision):
    """A's padded rows and columns hold taps in every plane, so T's padded
    rows are not zero; T's padded columns are, in every plane (D's are),
    which keeps the contractions over k >= 100 empty."""
    depth, abm = _case("rects")
    for tiles in _split(_taps(abm[:, 1]), PLANES[precision]):
        a = _a_from_tiles(tiles)
        assert float(a[:, HR_SIZE:, :].abs().max()) > 0 and float(a[:, :, HR_SIZE:].abs().max()) > 0
    _, _, t = kernel_model(depth, abm, PLANES[precision])
    assert float(t[:, :, HR_SIZE:, :].abs().amax(dim=(0, 2, 3)).min()) > 0
    assert torch.equal(t[..., HR_SIZE:], torch.zeros_like(t[..., HR_SIZE:]))
    # the tiled A equals the band matrix on the map, plane by plane
    idx = torch.arange(HR_SIZE)
    d = (idx[None, :] - idx[:, None]).float()
    beta = abm[:, 1].reshape(-1, 1, 1)
    band = torch.where(d.abs() <= 49, torch.exp(-C_PSF * d ** 2 / (beta * beta)), torch.zeros(()))
    for tiles, plane in zip(_split(_taps(abm[:, 1]), PLANES[precision]), _split(band, PLANES[precision])):
        assert torch.equal(_a_from_tiles(tiles)[:, :HR_SIZE, :HR_SIZE], plane)


@pytest.mark.parametrize("beta, edge_nonzero", [(0.05, False), (50.0, True)])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_band_edge_tiles(precision, beta, edge_nonzero):
    """At offset +-4 a tile holds only g(+-49) (and zeros beyond the band),
    in every plane: non-zero for a wide PSF, vanishing for a narrow one (at
    beta = 50, g(49) = 0.98020 is no bf16 value, so its lo part is not zero
    either)."""
    for tiles in _split(_taps(torch.tensor([beta])), PLANES[precision]):
        for t in (0, 2 * BAND_TILES):
            assert bool((tiles[0, t] != 0).any()) == edge_nonzero
            assert int((tiles[0, t] != 0).sum()) <= 1
