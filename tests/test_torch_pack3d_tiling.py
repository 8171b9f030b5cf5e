"""The tiling of the 3-D analysis kernels ``fwd_level1_pack`` and
``fwd_level2_pack`` (``csrc/pack3d.cu`` ``fwd_pack_kernel``), replayed on the
CPU in numpy at float64.

The kernel cannot run here, so this replays, block by block, what
``ops/pack3d.py:_fwd_pack_geometry`` tells it to do: which input samples
each staging item reads (directly in an interior tile, through the row and
column maps folded once per block elsewhere), which staged samples the W
and H stages reach, and which output elements each lane stores at which
flat offsets: the LLL as 2-vectors, the subband planes one value a lane,
the interleaved subbands as the 16-byte pieces of each warp's restage, a
half warp at a time (with its XOR swizzle, whose 16-byte phases must hit
distinct banks).
Every output element must be written exactly once and equal the plain
version (:func:`fwd_level1_pack_reference`,
:func:`fwd_level2_pack_reference`); every staged or restaged cell read
must have been written.  Edit the replay together with the kernel.
"""

import numpy as np
import pytest
import torch

from dtcwt_tpu_torch.coeffs import biort, qshift
from dtcwt_tpu_torch.ops import _build, fb, pack3d
from dtcwt_tpu_torch.ops.level2 import dfilt_streams

_THREADS = 256


def _reflect(j, n):
    """reflect() of csrc/common.cuh: symmetric reflection with repeated
    ends, folded as often as needed."""
    t = np.mod(j, 2 * n)
    return np.where(t < n, t, 2 * n - 1 - t)


def _fold(j, n):
    """fold() of csrc/common.cuh: the index itself inside the axis, one
    reflection where that lands inside, else reflect()."""
    f = np.where(j < 0, -1 - j, 2 * n - 1 - j)
    return np.where((j >= 0) & (j < n), j,
                    np.where((f >= 0) & (f < n), f, _reflect(j, n)))


def _slot(l, v, np_):
    """fwd_slot(): piece v of location l in a warp's restage."""
    return v ^ ((l // (8 // np_)) & (np_ - 1))


def _octant_bits(n):
    """oct_i, oct_j, oct_k of csrc/pack3d.cu for octant n."""
    return (0x66 >> n) & 1, (0x55 >> n) & 1, int(n >= 3)


def _stage_matrix(taps, lens, offs, b, n_out, n_in, P, D, S):
    """fir() of csrc/hwstage.cuh for filter b as a matrix: out[o] = M[o] @
    img, output o reading img[D (o // P) + off[b][s] + S t], s = o % P;
    every sample it reaches must lie in the staged image."""
    M = np.zeros((n_out, n_in))
    for o in range(n_out):
        g, s = divmod(o, P)
        for t in range(lens[b * P + s]):
            i = D * g + offs[b * P + s] + S * t
            assert 0 <= i < n_in, (o, i, n_in)
            M[o, i] += taps[b, s, t]
    return M


def _replay(lo, hi, plans, PDS, geo, planes, acc, Ho, Wo):
    """Run the kernel's index arithmetic on the branch volumes *lo*, *hi*
    [B, Dn, H, W]; return (lll [B, Dn, Ho, Wo], the flat subbands: the
    (re, im) planes [B, 28, Dn/2, Ho/2, Wo/2] or the interleaved real pairs
    [B, Dn/2, Ho/2, Wo/2, 28, 2]) and assert every write lands once."""
    P, D, S = PDS
    B, Dn, H, W = lo.shape
    taps, lens, offs = pack3d._table(plans)
    cmin = int(offs.min())
    offs = offs - cmin
    span = pack3d._span(plans, S)
    oh, ow, xr, xc, xn = geo.oh, geo.ow, geo.xr, geo.xc, geo.xn
    # the tile the C side accepts (fwd_tile_ok)
    for v in (oh, ow):
        assert 2 <= v <= 32 and v & (v - 1) == 0
    assert (xr, xc) == (D * (oh // P - 1) + span, D * (ow // P - 1) + span)
    assert xn == (xr * xc if planes else max(xr * xc, 4 * _THREADS))
    assert geo.smem == acc * (xn + 8 * xr * ow) + 4 * (xr + xc)
    assert geo.smem <= 220 * 1024
    Dh, Hb, Wb = Dn // 2, Ho // 2, Wo // 2
    assert geo.grid == (B, Dh, -(-Ho // oh), -(-Wo // ow))
    # the staging walk: thread tid's (r, c), stepped by PACK_THREADS items
    # without a division, is the item's own
    r, c = np.divmod(np.arange(_THREADS), xc)
    dr, dc = divmod(_THREADS, xc)
    for i0 in range(0, xr * xc, _THREADS):
        i = i0 + np.arange(_THREADS)
        live = i < xr * xc
        assert (r[live] * xc + c[live] == i[live]).all()
        r, c = r + dr, c + dc
        r, c = np.where(c >= xc, r + 1, r), np.where(c >= xc, c - xc, c)
    mw = [_stage_matrix(taps, lens, offs, k, ow, xc, P, D, S)
          for k in range(2)]
    mh = [_stage_matrix(taps, lens, offs, j, oh, xr, P, D, S)
          for j in range(2)]
    lll = np.zeros(B * Dn * Ho * Wo)
    nl = np.zeros(lll.size, np.int64)
    nbands = B * 28 * Dh * Hb * Wb
    bands = np.zeros((2, nbands)) if planes else np.zeros(2 * nbands)
    nb = np.zeros(bands.shape, np.int64)
    vn = 16 // acc
    np_ = 8 // vn
    NL = (oh // 2) * (ow // 2)
    BX = ow // 2
    tid = np.arange(_THREADS)
    lane, warp = tid & 31, tid >> 5
    for b in range(B):
        for u in range(Dh):
            for th in range(geo.grid[2]):
                for tw in range(geo.grid[3]):
                    o0r, o0c = th * oh, tw * ow
                    rstart = D * (o0r // P) + cmin
                    cstart = D * (o0c // P) + cmin
                    inner = (rstart >= 0 and rstart + xr <= H
                             and cstart >= 0 and cstart + xc <= W)
                    rows = rstart + np.arange(xr)
                    cols = cstart + np.arange(xc)
                    if not inner:
                        rows, cols = _fold(rows, H), _fold(cols, W)
                    assert (rows == _reflect(rstart + np.arange(xr), H)).all()
                    assert (cols == _reflect(cstart + np.arange(xc), W)).all()
                    # W stage per slice sl = 2 i + c and W branch k
                    wi = np.empty((4, 2, xr, ow))
                    for sl in range(4):
                        src = (lo if sl < 2 else hi)[b, 2 * u + (sl & 1)]
                        xs = src[rows[:, None], cols[None, :]]
                        for k in range(2):
                            wi[sl, k] = xs @ mw[k].T
                    # H stage: the corners of every band location
                    img = np.einsum("jor,skrw->skjow", np.stack(mh), wi)

                    def corner(sl, j, k, hp, wp):
                        return img[sl, k, j][2 * py + hp, 2 * qx + wp]
                    py, qx = np.divmod(np.minimum(tid, NL - 1), BX)
                    p, q = o0r // 2 + py, o0c // 2 + qx
                    inn = (tid < NL) & (p < Hb) & (q < Wb)
                    for cc in range(2):
                        for hp in range(2):
                            off = (((b * Dn + 2 * u + cc) * Ho + 2 * p + hp)
                                   * Wo + 2 * q)[inn]
                            assert (off % 2 == 0).all()    # a 2-vector
                            for wp in range(2):
                                np.add.at(nl, off + wp, 1)
                                lll[off + wp] = corner(cc, 0, 0, hp,
                                                       wp)[inn]
                    _pack(corner, inn, tid, lane, warp, p, q, b, u, Dh, Hb,
                          Wb, NL, BX, o0r, o0c, planes, vn, np_, acc, bands,
                          nb)
    assert (nl == 1).all(), "LLL elements written %s times" % set(nl)
    assert (nb == 1).all(), "subband elements written %s times" % set(
        nb.reshape(-1))
    lll = lll.reshape(B, Dn, Ho, Wo)
    if planes:
        return lll, bands.reshape(2, B, 28, Dh, Hb, Wb)
    return lll, bands.reshape(B, Dh, Hb, Wb, 28, 2)


def _pack(corner, inn, tid, lane, warp, p, q, b, u, Dh, Hb, Wb, NL, BX, o0r,
          o0c, planes, vn, np_, acc, bands, nb):
    """The cube2c pack of the 7 octants and their stores, one lane a band
    location (lane tid of the tile's NL, row-major): planes one value a
    lane, or each warp's restage, half a warp at a time, and its 16-byte
    pieces."""
    live_warps = np.unique(warp[32 * warp < NL])
    for n in range(7):
        i, j, k = _octant_bits(n)
        assert (i, j, k) == pack3d._OCTANTS[n]
        s0 = 2 * i
        cA, cB = corner(s0, j, k, 0, 0), corner(s0, j, k, 1, 0)
        cC, cD = corner(s0 + 1, j, k, 0, 0), corner(s0 + 1, j, k, 1, 0)
        cE, cF = corner(s0, j, k, 0, 1), corner(s0, j, k, 1, 1)
        cG, cH = corner(s0 + 1, j, k, 0, 1), corner(s0 + 1, j, k, 1, 1)
        re = [(cA - cG - cD - cF) / 2, (cA - cG + cD + cF) / 2,
              (cA + cG + cD - cF) / 2, (cA + cG - cD + cF) / 2]
        im = [(cB - cH + cC + cE) / 2, (-cB + cH + cC + cE) / 2,
              (cB + cH - cC + cE) / 2, (-cB - cH - cC + cE) / 2]
        if planes:
            for m in range(4):
                off = ((((b * 28 + 4 * n + m) * Dh + u) * Hb + p) * Wb
                       + q)[inn]
                for a, v in ((0, re[m]), (1, im[m])):
                    np.add.at(nb[a], off, 1)
                    bands[a, off] = v[inn]
            continue
        z = np.stack([v for m in range(4) for v in (re[m], im[m])], -1)
        for h in range(2):
            # lanes 16 h .. 16 h + 15 restage their location's octant in
            # the warp's [16][8], 16-byte phases on distinct banks
            ws = np.full((8, 16, 8), np.nan)
            wr = inn & (lane >> 4 == h)
            lw = lane & 15
            for v in range(np_):
                cell = 8 * lw + vn * _slot(lw, v, np_)
                for w in live_warps:
                    for ph in range(2 * h, 2 * h + 2):
                        sel = (warp == w) & (lane // 8 == ph) & wr
                        groups = (cell[sel] * acc // 16) % 8
                        assert len(set(groups)) == sel.sum()
                for t in range(vn):
                    ws[warp[wr], lw[wr], vn * _slot(lw[wr], v, np_) + t] = \
                        z[wr, v * vn + t]
            # then all 32 lanes store the half's 16 x np_ pieces
            for e in range(np_ // 2):
                kk = 32 * e + lane
                l, part = kk // np_, kk % np_
                li = 32 * warp + 16 * h + l
                ly, lx = np.divmod(li, BX)
                lp, lq = o0r // 2 + ly, o0c // 2 + lx
                ok = (li < NL) & (lp < Hb) & (lq < Wb) & (32 * warp < NL)
                cell = 8 * l + vn * _slot(l, part, np_)
                # the reads of a phase are contiguous: distinct banks
                for w in live_warps:
                    for ph in range(4):
                        sel = (warp == w) & (lane // 8 == ph)
                        assert len(set((cell[sel] * acc // 16) % 8)) == 8
                off = (((b * Dh + u) * Hb + lp) * Wb + lq) * 56 + 8 * n + \
                    vn * part
                assert (off[ok] % vn == 0).all()    # a 16-byte piece
                for t in range(vn):
                    val = ws[warp[ok], l[ok], vn * _slot(l[ok], part[ok],
                                                         np_) + t]
                    assert not np.isnan(val).any()  # restaged before read
                    np.add.at(nb, off[ok] + t, 1)
                    bands[off[ok] + t] = val


def _case(level, fam):
    """(filters in the call order, plans, (P, D, S), reference entry)."""
    if level == 1:
        b = biort(fam)
        f = (b[0], b[2])
        return (f, pack3d._filter_plans(*f), (1, 1, 1),
                pack3d.fwd_level1_pack_reference,
                lambda x: fb.filter2_axis(x, *f, -3))
    q = qshift(fam)
    f = ((q[1], q[0]), (q[5], q[4]))
    return (f, [dfilt_streams(*p) for p in f], (2, 4, 2),
            pack3d.fwd_level2_pack_reference,
            lambda x: fb.dfilt2_axis(x, *f, -3))


# (dtype, planes): the f32 interleaved, f32 / bf16 planes (one geometry)
# and f64 geometries
_KINDS = [(torch.float32, False), (torch.float32, True),
          (torch.float64, False), (torch.float64, True)]
# [B, D, H, W] volumes a level reads: tiles crossed both ways with the last
# one partial, band rows ending inside a warp's run (W / 2 = 22, 34),
# H and W shorter than the longer filters, a batch
_SHAPES = {1: [(1, 2, 36, 44), (2, 4, 6, 10), (1, 2, 66, 68)],
           2: [(1, 4, 8, 12), (1, 4, 72, 136), (2, 4, 36, 20)]}


@pytest.mark.parametrize("shape_no", range(3))
@pytest.mark.parametrize("level,fam", [
    (1, "near_sym_a"), (1, "near_sym_b"), (1, "antonini"),
    (2, "qshift_a"), (2, "qshift_d"), (2, "qshift_32")])
def test_fwd_pack_tiling_replay(level, fam, shape_no):
    """Each block's reads and writes for the f32 (interleaved and planes)
    and f64 geometries, against the plain version at float64."""
    shape = _SHAPES[level][shape_no]
    f, plans, PDS, ref, depth = _case(level, fam)
    x = torch.from_numpy(np.random.RandomState(sum(shape) + level).rand(
        *shape))
    lo, hi = (v.numpy() for v in depth(x))
    B, Dn, H, W = lo.shape
    Ho, Wo = (H, W) if level == 1 else (H // 2, W // 2)
    for dtype, planes in _KINDS:
        want_lll, want = ref(x, *f, planes=planes)
        acc = 8 if dtype == torch.float64 else 4
        geo = pack3d._fwd_pack_geometry(
            B, Dn, Ho, Wo, PDS[0], PDS[1], pack3d._span(plans, PDS[2]),
            dtype, planes)
        lll, bands = _replay(lo, hi, plans, PDS, geo, planes, acc, Ho, Wo)
        np.testing.assert_allclose(lll, want_lll.numpy(), rtol=0,
                                   atol=1e-12)
        if planes:
            for a in range(2):
                np.testing.assert_allclose(bands[a], want[a].numpy(), rtol=0,
                                           atol=1e-12)
        else:
            np.testing.assert_allclose(
                bands, torch.view_as_real(want).numpy(), rtol=0, atol=1e-12)


def test_fwd_pack_geometry_main_path():
    """The main path's tiles (256^3 at 3 levels: level 1 on 256^2 slices,
    level 2 on 128^2 and 64^2 outputs): 32 x 32 output samples wherever
    they fit, the restage in the staged slice's space, and the shared
    memory that leaves an SM five blocks of level 1 (near_sym_a) and two
    of level 2 (qshift_a), in float32."""
    sm = 233472                    # an H100 SM; 1 KB of it a block's
    for fam, want in (("near_sym_a", (38, 1444, 44992, 5)),
                      ("near_sym_b", (50, 2500, 61600, 3)),
                      ("antonini", (40, 1600, 47680, 4))):
        _, plans, _, _, _ = _case(1, fam)
        geo = pack3d._fwd_pack_geometry(1, 256, 256, 256, 1, 1,
                                        pack3d._span(plans, 1),
                                        torch.float32, False)
        assert (geo.oh, geo.ow, geo.xr, geo.xn, geo.smem) == (32, 32) + \
            want[:3]
        assert sm // (geo.smem + 1024) == want[3]
        assert geo.grid == (1, 128, 8, 8)
    for fam, span in (("qshift_a", 20), ("qshift_b", 28), ("qshift_d", 36)):
        _, plans, _, _, _ = _case(2, fam)
        assert pack3d._span(plans, 2) == span
        for Ho in (128, 64):
            for planes in (False, True):
                geo = pack3d._fwd_pack_geometry(1, 128, Ho, Ho, 2, 4, span,
                                                torch.float32, planes)
                xr = 60 + span
                assert (geo.oh, geo.ow, geo.xr, geo.xc, geo.xn) == (
                    32, 32, xr, xr, xr * xr)
                assert geo.smem == 4 * (xr * xr + 8 * xr * 32) + 8 * xr
                assert geo.grid == (1, 64, Ho // 32, Ho // 32)
                if fam == "qshift_a":
                    assert sm // (geo.smem + 1024) == 2
    # float64 with the longest qshift halves the tile until it fits
    _, plans, _, _, _ = _case(2, "qshift_32")
    geo = pack3d._fwd_pack_geometry(1, 2, 8, 8, 2, 4, pack3d._span(plans, 2),
                                    torch.float64, False)
    assert (geo.oh, geo.ow) == (16, 16) and geo.smem <= 220 * 1024
    assert geo.smem <= _build.SMEM_LIMIT
