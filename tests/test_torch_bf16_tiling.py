"""The blocking of the one-pass bf16 physics kernel
(``tactilesr_torch/ops/cuda/tpsf_kernel.cu``, ``tpsf_physics_bf16_kernel``,
``physics_precision: default``), modelled in plain PyTorch on the CPU.

The kernel cannot run here, so this file keeps a model of its arithmetic
(not in the package) and holds it against the plain version
``physics_plain(depth, abm, "default")``:

- A(beta) is built from nine 16x16 Toeplitz tiles (block offsets -4..4),
  so A's padded rows and columns (100..111) hold taps, not zeros; D is
  padded to 112 with zeros;
- T = A . D is rounded to bf16 as the next product's operand;
- the epilogue reads only i, j < 100: the second max over the non-contact
  HR0 with the contact pixels' zeros as its floor, and
  sum(HR) = sum of the non-contact HR0 + count * second;
- V = U . bf16(HR) is the sum of the seven 16-row stripes' partials, taken
  in stripe order, and LR = (bf16(V) . U^T - mn sum(HR)) / (1 - mn) 1e-4.

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


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _tiles(beta):
    """(B,) beta -> (B, 9, 16, 16): tile t (block offset o = t - 4) holds
    bf16(g(16 o + c - r)) at (r, c), g(d) = exp(-C_PSF d^2 / beta^2) for
    |d| <= 49, else 0 (the kernel's gpad)."""
    o = torch.arange(-BAND_TILES, BAND_TILES + 1)[:, None, None]
    d = (BLK * o + torch.arange(BLK)[None, None, :] - torch.arange(BLK)[None, :, None]).float()
    b = beta.reshape(-1, 1, 1, 1)
    g = torch.exp(-C_PSF * d ** 2 / (b * b))
    return _bf16(torch.where(d.abs() <= 49, g, torch.zeros(())))


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
    """(B,) m -> U (B, 4, 100) rounded to bf16."""
    x = torch.arange(HR_SIZE, dtype=torch.float32)
    c = torch.arange(TAXELS, dtype=torch.float32)[:, None] * TAXEL_PITCH + TAXEL_CENTER_0
    return _bf16(torch.exp(-C_MASK * (x - c) ** 2 / m.reshape(-1, 1, 1)))


def kernel_model(depth, abm):
    """The kernel's arithmetic: depth (B,100,100), abm (B,3) ->
    (HR, LR, T (B,112,112) f32 of bf16 values)."""
    depth = depth.float()
    alpha, beta, m = abm[:, 0].reshape(-1, 1, 1), abm[:, 1], abm[:, 2]
    b = depth.shape[0]
    tiles = _tiles(beta)
    d = torch.zeros(b, MP, MP)
    d[:, :HR_SIZE, :HR_SIZE] = _bf16(depth)
    t = _bf16(torch.matmul(_a_from_tiles(tiles), d))
    hr0 = (alpha * torch.matmul(t, _at_from_tiles(tiles)))[:, :HR_SIZE, :HR_SIZE]
    mx = depth.amax(dim=(-2, -1), keepdim=True)
    contact = depth > mx - DISTURBANCE
    zero = torch.zeros(())
    non_contact = torch.where(contact, zero, hr0)
    second = non_contact.amax(dim=(-2, -1), keepdim=True).clamp_min(0.0)
    count = contact.sum(dim=(-2, -1), keepdim=True).float()
    hsum = non_contact.sum(dim=(-2, -1), keepdim=True) + count * second
    hr = torch.where(contact, second, hr0)
    u = _u(m)
    up = torch.zeros(b, TAXELS, MP)
    up[:, :, :HR_SIZE] = u
    hp = torch.zeros(b, MP, MP)
    hp[:, :HR_SIZE, :HR_SIZE] = _bf16(hr)
    v = torch.zeros(b, TAXELS, MP)
    for w in range(MT):  # the stripes' partials, in stripe order
        rows = slice(BLK * w, BLK * (w + 1))
        v = v + torch.matmul(up[:, :, rows], hp[:, rows, :])
    mn = torch.exp(-100.0 / m).reshape(-1, 1, 1)
    t2 = torch.matmul(_bf16(v[:, :, :HR_SIZE]), u.transpose(-2, -1))
    lr = (t2 - mn * hsum) / (1.0 - mn) * DEGRADE_SCALE
    return hr, lr, t


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
def test_model_matches_plain(name):
    depth, abm = _case(name)
    hr, lr, _ = kernel_model(depth, abm)
    hr_p, lr_p = physics_plain(depth, abm, "default")
    assert torch.isfinite(hr).all() and torch.isfinite(lr).all()
    assert _rel(hr, hr_p) < REL and _rel(lr, lr_p) < REL, (_rel(hr, hr_p), _rel(lr, lr_p))


def test_all_contact_map_has_second_max_zero():
    """Every pixel in contact: the second max is its floor 0, so HR and LR
    are zero, in the model as in the plain version."""
    depth, abm = _case("all_contact")
    hr, lr, _ = kernel_model(depth, abm)
    hr_p, lr_p = physics_plain(depth, abm, "default")
    assert torch.equal(hr, torch.zeros_like(hr)) and torch.equal(hr_p, torch.zeros_like(hr_p))
    assert float(lr.abs().max()) == 0.0 and float(lr_p.abs().max()) == 0.0


def test_all_zero_map_gives_exact_zeros():
    depth = torch.zeros(2, HR_SIZE, HR_SIZE)
    abm = torch.from_numpy(_abm(np.random.default_rng(7), 2))
    hr, lr, t = kernel_model(depth, abm)
    assert torch.equal(t, torch.zeros_like(t))
    assert torch.equal(hr, torch.zeros_like(hr)) and torch.equal(lr, torch.zeros_like(lr))


def test_padding_holds_taps_and_the_map_stays_exact():
    """A's padded rows and columns hold taps, so T's padded rows are not
    zero; T's padded columns are (D's are), which keeps the contractions
    over k >= 100 empty."""
    depth, abm = _case("rects")
    a = _a_from_tiles(_tiles(abm[:, 1]))
    assert float(a[:, HR_SIZE:, :].abs().max()) > 0 and float(a[:, :, HR_SIZE:].abs().max()) > 0
    _, _, t = kernel_model(depth, abm)
    assert float(t[:, HR_SIZE:, :].abs().max()) > 0
    assert torch.equal(t[:, :, HR_SIZE:], torch.zeros_like(t[:, :, HR_SIZE:]))
    # the tiled A equals the band matrix on the map
    idx = torch.arange(HR_SIZE)
    d = (idx[None, :] - idx[:, None]).float()
    beta = abm[:, 1].reshape(-1, 1, 1)
    band = _bf16(torch.where(d.abs() <= 49, torch.exp(-C_PSF * d ** 2 / (beta * beta)), torch.zeros(())))
    assert torch.equal(a[:, :HR_SIZE, :HR_SIZE], band)


@pytest.mark.parametrize("beta, edge_nonzero", [(0.05, False), (50.0, True)])
def test_band_edge_tiles(beta, edge_nonzero):
    """At offset +-4 a tile holds only g(+-49) (and zeros beyond the band):
    non-zero for a wide PSF, vanishing for a narrow one."""
    tiles = _tiles(torch.tensor([beta]))
    for t in (0, 2 * BAND_TILES):
        assert bool((tiles[0, t] != 0).any()) == edge_nonzero
        assert int((tiles[0, t] != 0).sum()) <= 1
