"""Batched banded Smith-Waterman extension (port of compseed_tpu/ops/bsw.py).

Exact integer semantics of ksw_extend2 (bwalib/ksw.c:380-479).
``_extend_core`` is the PLAIN PyTorch version of the DP: one pair per
row of a (P, Q) state, scanned over target rows, with the adaptive band,
z-drop, early break and last-argmax ties reproduced by masks.  It runs
for CPU tensors and is what the CUDA kernel (ops/bsw_cuda.py) is held
against on the card.  With ``state16=True`` it is the plain version of
the kernel's int16-state variant: the H and E rows are kept in int16
tensors between target rows and widened to int32 for each row's
arithmetic.

``BswRunner`` is the engine the native tail calls: it pads pair batches
to bucketed shapes, sorts pairs by target length (so threads of one warp
finish together) and runs the DP through ``bsw_cuda.bsw_extend_tiles``,
which launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from compseed_tpu_torch.ops import bsw_cuda

NEG = -(1 << 29)


def _extend_core(o_del: int, e_del: int, o_ins: int, e_ins: int,
                 zdrop: int, mat: torch.Tensor, w, queries, qlens, targets,
                 tlens, h0s, state16: bool = False,
                 count_cells: bool = False):
    """DP body with the band already clamped per pair (w: (P,) int32).

    mat (5, 5); queries (P, Q) and targets (P, T) codes 0..4; qlens,
    tlens, h0s (P,).  state16: store the H/E rows as int16 between rows
    (no numeric change while every stored value fits 16 bits, which
    ``BswRunner._use16`` proves).  Returns (6, P) int32: score, qle, tle,
    gtle, gscore, max_off — and with count_cells also the number of band
    cells these pairs need (the sum over rows and live pairs of the band
    width), which is the work a per-pair kernel does on them."""
    P, Q = queries.shape
    T = targets.shape[1]
    dev = queries.device
    i32 = torch.int32
    sdt = torch.int16 if state16 else i32      # storage type of the rows
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins

    qlens = qlens.to(i32)
    tlens = tlens.to(i32)
    h0s = h0s.to(i32)
    w = w.to(i32)
    mat = mat.reshape(5, 5).to(i32)

    jj = torch.arange(Q + 1, dtype=i32, device=dev)[None, :]   # eh grid
    jq = torch.arange(Q, dtype=i32, device=dev)[None, :]       # columns

    # first row init (ksw.c:395-397): h[j] = max(h0 - oe_ins - (j-1)e, 0)
    v = h0s[:, None] - oe_ins - (jj - 1) * e_ins
    h = torch.where(jj == 0, h0s[:, None], v.clamp(min=0))
    h_st = torch.where(jj <= qlens[:, None], h, 0).to(sdt)
    e_st = torch.zeros((P, Q + 1), dtype=sdt, device=dev)

    # per-base query profiles; a row selects by its target char
    qidx = queries.to(torch.int64)
    qprof = [mat[c][qidx] for c in range(5)]                   # 5 x (P, Q)

    beg = torch.zeros(P, dtype=i32, device=dev)
    end = qlens.clone()
    best = h0s.clone()
    max_i = torch.full((P,), -1, dtype=i32, device=dev)
    max_j = max_i.clone()
    max_ie = max_i.clone()
    gscore = max_i.clone()
    max_off = torch.zeros(P, dtype=i32, device=dev)
    broken = torch.zeros(P, dtype=torch.bool, device=dev)
    neg_col = torch.full((P, 1), NEG, dtype=i32, device=dev)
    zero_col = torch.zeros((P, 1), dtype=i32, device=dev)
    cells = torch.zeros((), dtype=torch.int64, device=dev)

    i = 0
    while i < T and bool(((~broken) & (i < tlens)).any()):
        h = h_st.to(i32)                     # widen on load
        e = e_st.to(i32)
        active = (~broken) & (i < tlens)
        beg_i = torch.maximum(beg, torch.full_like(beg, i) - w)
        end_i = torch.minimum(torch.minimum(end, i + w + 1), qlens)
        empty = end_i <= beg_i
        if count_cells:
            cells += torch.where(active, (end_i - beg_i).clamp(min=0),
                                 0).sum()
        h_first = torch.where(beg_i == 0,
                              (h0s - (o_del + e_del * (i + 1))).clamp(min=0),
                              0).to(i32)

        tchar = targets[:, i].to(i32)
        score = qprof[4]
        for c in range(4):
            score = torch.where((tchar == c)[:, None], qprof[c], score)

        inb = (jq >= beg_i[:, None]) & (jq < end_i[:, None])
        Hdiag = h[:, :Q]
        Eprev = e[:, :Q]
        M = torch.where(Hdiag != 0, Hdiag + score, 0)
        e_new = torch.maximum(Eprev - e_del, (M - oe_del).clamp(min=0))
        t_ins = (M - oe_ins).clamp(min=0)

        # F prefix scan with a pseudo source (value 0) at column beg
        t_pad = torch.cat([neg_col, torch.where(inb, t_ins, NEG)], dim=1)
        t_src = torch.where(jj == beg_i[:, None], 0, t_pad)
        run = torch.cummax(t_src + jj * e_ins, dim=1).values
        f = run[:, :Q] - jq * e_ins

        h_new = torch.maximum(torch.maximum(M, Eprev), f)

        # row max and its LAST column (ksw.c:437-438 tie semantics)
        h_band = torch.where(inb, h_new, 0)
        m = h_band.max(dim=1).values
        is_max = (h_band == m[:, None]) & inb
        mj = torch.where(is_max, jq, -1).max(dim=1).values
        mj = torch.where(m == 0, -1, mj)

        # shifted row back: h[jj] = h_first at beg, H(i, jj-1) for
        # beg < jj <= end; e[jj] = e_new in band, 0 at end
        h_prev = torch.cat([zero_col, h_new], dim=1)
        upd1 = jj == beg_i[:, None]
        upd2 = (jj > beg_i[:, None]) & (jj <= end_i[:, None])
        h_out = torch.where(upd1, h_first[:, None],
                            torch.where(upd2, h_prev, h))
        e_pad = torch.cat([e_new, zero_col], dim=1)
        inb_e = (jj >= beg_i[:, None]) & (jj < end_i[:, None])
        e_out = torch.where(inb_e, e_pad,
                            torch.where(jj == end_i[:, None], 0, e))
        h_st = torch.where(active[:, None], h_out, h).to(sdt)
        e_st = torch.where(active[:, None], e_out, e).to(sdt)
        h_out = h_st.to(i32)                 # narrow on store: what the
        e_out = e_st.to(i32)                 # band shrink reads back

        # to-query-end score (ksw.c:450-453)
        last_col = (end_i - 1).clamp(min=0).to(torch.int64)[:, None]
        h1_last = torch.where(empty, h_first,
                              torch.gather(h_new, 1, last_col)[:, 0])
        at_qend = active & (end_i == qlens)
        upd_g = at_qend & (gscore <= h1_last)
        max_ie = torch.where(upd_g, i, max_ie)
        gscore = torch.where(at_qend, torch.maximum(gscore, h1_last), gscore)

        # break / best / z-drop (ksw.c:454-463)
        brk0 = m == 0
        better = m > best
        upd_b = active & better
        di = i - max_i
        dj = mj - max_j
        zd_del = best - m - (di - dj) * e_del > zdrop
        zd_ins = best - m - (dj - di) * e_ins > zdrop
        zd = torch.where(di > dj, zd_del, zd_ins)
        brk = brk0 | ((~better) & zd) if zdrop > 0 else brk0
        max_off = torch.where(upd_b, torch.maximum(max_off, (mj - i).abs()),
                              max_off)
        best = torch.where(upd_b, m, best)
        max_i = torch.where(upd_b, i, max_i)
        max_j = torch.where(upd_b, mj, max_j)
        broken = broken | (active & brk)

        # band shrink to the non-zero span (ksw.c:465-469), on the
        # updated arrays; skipped for lanes that just broke
        nz = (h_out != 0) | (e_out != 0)
        c1 = nz & (jj >= beg_i[:, None]) & (jj < end_i[:, None])
        beg_new = torch.where(c1, jj, end_i[:, None]).min(dim=1).values
        c2 = nz & (jj >= beg_new[:, None]) & (jj <= end_i[:, None])
        last = torch.where(c2, jj, (beg_new - 1)[:, None]).max(dim=1).values
        end_new = torch.minimum(last + 2, qlens)
        keep = active & ~brk
        beg = torch.where(keep, beg_new, beg)
        end = torch.where(keep, end_new, end)
        i += 1

    out = torch.stack([best, max_j + 1, max_i + 1, max_ie + 1, gscore,
                       max_off]).to(i32)
    return (out, cells) if count_cells else out


def _meta_dual_core(mat, qflat, pac, meta, *, Q, T, L, l_pac, o_del, e_del,
                    o_ins, e_ins, zdrop, w0, wide_r0=False, state16=False):
    """Both band-doubling DP rounds + the retry acceptance: round 0 at
    the nominal band w0, the reference's acceptance test (score unchanged
    OR max_off < (w>>1)+(w>>2), comp_seed.cpp:1732-1767), then round 1 at
    2*w0 only for rejected lanes (accepted lanes get tlen=0 and exit at
    once).  meta columns: rid, q0, qlen, rev, r0_lo, r0_hi, rlen, h0,
    prev_score, ws0, ws1, pad.  Returns (P, 8) int32: the six DP results
    of the accepted round + col 6 = accepted round index."""
    i32 = torch.int32
    qmeta = meta[:, 0:4]
    if wide_r0:
        r0 = (meta[:, 4].to(torch.int64) & 0xFFFFFFFF) | \
            (meta[:, 5].to(torch.int64) << 32)
    else:
        r0 = meta[:, 4]
    rlen = meta[:, 6]
    h0s = meta[:, 7:8]
    prev = meta[:, 8]
    ws0 = meta[:, 9:10]
    ws1 = meta[:, 10:11]
    qt, ql, tt = bsw_cuda.build_tiles(qflat, pac, qmeta, r0, rlen,
                                      Q=Q, T=T, L=L, l_pac=l_pac)
    ql = ql[:, None].to(i32).contiguous()

    def dp(tl, ws):
        return bsw_cuda.bsw_extend_tiles(
            mat, qt, ql, tt, tl[:, None].to(i32).contiguous(),
            h0s.contiguous(), ws.contiguous(), o_del=o_del, e_del=e_del,
            o_ins=o_ins, e_ins=e_ins, zdrop=zdrop, state16=state16)

    out0 = dp(rlen, ws0)
    accept0 = (out0[:, 0] == prev) | \
        (out0[:, 5] < ((w0 >> 1) + (w0 >> 2)))
    out1 = dp(torch.where(accept0, 0, rlen), ws1)
    res = torch.where(accept0[:, None], out0[:, :6], out1[:, :6])
    rnd = torch.where(accept0, 0, 1).to(i32)
    return torch.cat([res, rnd[:, None], torch.zeros_like(rnd)[:, None]],
                     dim=1)


bsw_meta_dual = _meta_dual_core


def _bucket(x: int, lo: int) -> int:
    """Next power-of-two-ish size >= x, to bound the set of shapes."""
    b = lo
    while b < x:
        b <<= 1
    return b


def _q_classes(qlens: np.ndarray, lo: int = 128):
    """Partition pair indices by the power-of-two bucket of their query
    length: short-query pairs must not pay a long pair's state width.
    Yields (bucket, indices) pairs."""
    n = len(qlens)
    buck = np.full(n, lo, np.int32)
    b = lo
    while (qlens > b).any():
        b <<= 1
        buck[qlens > b >> 1] = b
    for bv in np.unique(buck):
        yield int(bv), np.nonzero(buck == bv)[0]


def _pack_rows(buf: np.ndarray, off: np.ndarray, P: int, W: int) -> tuple:
    """Scatter flat concatenated segments into a padded (P, W) matrix."""
    n = len(off) - 1
    lens = (off[1:] - off[:-1]).astype(np.int64)
    out = np.full((P, W), 4, dtype=np.uint8)
    if len(buf):
        rows = np.repeat(np.arange(n), lens)
        cols = np.arange(len(buf)) - np.repeat(off[:-1], lens)
        out[rows, cols] = buf
    return out, lens.astype(np.int32)


class BswRunner:
    """Pads pair batches to bucketed shapes and runs the DP on ``device``:
    the CUDA kernel for a CUDA device (after ``bsw_cuda.self_check`` has
    shown that the library launches there), the plain version for the CPU.
    Pairs are sorted by target length so that the threads of a warp
    early-exit together (the reference's sortPairsLen radix bucketing,
    mapping/comp_seed.cpp:1275-1314)."""

    def __init__(self, opt, mat: np.ndarray, device: torch.device,
                 dfi=None):
        self.opt = opt
        self.device = torch.device(device)
        m = np.asarray(mat).reshape(5, 5).astype(np.int32)
        # the kernel and the plain version both score mat[tchar][qchar]
        # from the full matrix, so every scoring matrix is served
        self.mat = torch.from_numpy(m.copy()).to(self.device)
        self.max_sc = int(m.max())
        self.dfi = dfi               # device index (pac) for the meta path
        self._qctx = None            # (qflat device tensor, L) per chunk
        self._row_map = None         # read id -> qd row (sharded layout)
        # int16 DP state, opt-in: halves the H/E row traffic for the
        # query-length classes whose stored values provably fit (_use16)
        self.state16 = os.environ.get("COMPSEED_BSW_I16", "0") == "1"
        if self.device.type == "cuda":
            bsw_cuda.self_check(self.device)
        # sub-phase timers for the tail's "engine" bucket: pack = host
        # numpy, call = enqueue, fetch = D2H copy (waits for the DP)
        self.prof: dict[str, float] = {}

    def _use16(self, Q: int, h0max: int) -> bool:
        """True when every STORED int16 value provably fits: the binding
        bound is the stored H/E range, H <= h0 + Q*a.  The extra
        (Q-1)*e terms are the JAX package's deliberately conservative
        margin, kept so both packages pick the same kernel per class —
        they only ever disable the storage optimization, never
        correctness."""
        if not self.state16:
            return False
        opt = self.opt
        e = max(opt.e_ins, opt.e_del, 1)
        return ((Q - 1) * e < 16000 and
                h0max + Q * self.max_sc + (Q - 1) * opt.e_ins < 32000)

    def run_flat(self, qbuf: np.ndarray, qoff: np.ndarray, rbuf: np.ndarray,
                 roff: np.ndarray, h0: np.ndarray, w: int, pen_clip: int):
        """Flat-buffer interface; returns six (n,) int32 numpy arrays."""
        if len(h0) == 0:
            z = np.zeros(0, np.int32)
            return (z,) * 6
        return self._run_kernel(qbuf, qoff, rbuf, roff, h0, w, pen_clip)

    def set_query_context(self, qd, L: int = 0, row_map=None) -> None:
        """Per-chunk device read matrix for metadata-only pair transfer;
        call with None to clear.  ``row_map`` maps a read id to its row
        in qd when the layout is not row == read id."""
        if qd is None:
            self._qctx = None
            self._row_map = None
            return
        self._qctx = (qd.reshape(-1), L)
        self._row_map = row_map

    @property
    def supports_meta(self) -> bool:
        return self.dfi is not None and self._qctx is not None

    @property
    def supports_meta_dual(self) -> bool:
        return self.supports_meta

    def _bands(self, qlens, w, pen_clip):
        opt = self.opt
        return bsw_cuda.clamp_band(qlens, w, self.max_sc, pen_clip,
                                   opt.o_del, opt.e_del, opt.o_ins,
                                   opt.e_ins)

    def _remap(self, qmeta):
        if self._row_map is not None:
            qmeta = qmeta.copy()
            qmeta[:, 0] = self._row_map[qmeta[:, 0]]
        return qmeta

    def run_meta(self, qmeta: np.ndarray, rmeta: np.ndarray,
                 h0: np.ndarray, w: int, pen_clip: int):
        """Pair metadata interface: sequences are sliced on the device
        from the chunk read matrix + packed reference."""
        opt = self.opt
        n = len(h0)
        if n == 0:
            z = np.zeros(0, np.int32)
            return (z,) * 6
        qflat, L = self._qctx
        qmeta = self._remap(qmeta)
        qlens = qmeta[:, 2].astype(np.int32)
        tlens = rmeta[:, 1].astype(np.int32)
        res = np.zeros((n, 6), np.int32)
        dev = self.device
        for Q, cls in _q_classes(qlens):
            m = len(cls)
            order = cls[np.argsort(tlens[cls], kind="stable")]
            P = _bucket(m, bsw_cuda.LT)
            T = _bucket(int(tlens[order].max(initial=1)), 128)
            s16 = self._use16(Q, int(h0[order].max(initial=0)))
            qm = np.zeros((P, 4), np.int32)
            qm[:m] = qmeta[order]
            r0 = np.zeros(P, np.int64)
            r0[:m] = rmeta[order, 0]
            rl = np.zeros(P, np.int32)
            rl[:m] = tlens[order]
            h0p = np.ones((P, 1), np.int32)
            h0p[:m, 0] = h0[order]
            ws = np.full((P, 1), w, np.int32)
            ws[:m, 0] = self._bands(qlens[order], w, pen_clip)
            qt, ql, tt = bsw_cuda.build_tiles(
                qflat, self.dfi.pac_words, _t(qm, dev),
                _t(r0, dev).to(self.dfi.dtype), _t(rl, dev),
                Q=Q, T=T, L=L, l_pac=self.dfi.l_pac)
            out = bsw_cuda.bsw_extend_tiles(
                self.mat, qt, ql[:, None].to(torch.int32).contiguous(), tt,
                _t(rl[:, None], dev), _t(h0p, dev), _t(ws, dev),
                o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                e_ins=opt.e_ins, zdrop=opt.zdrop, state16=s16).cpu().numpy()
            res[order] = out[:m, :6]
        # each result crosses a raw ctypes pointer into the native tail,
        # which indexes it densely: must be C-contiguous
        return tuple(np.ascontiguousarray(res[:, j]) for j in range(6))

    def run_meta_dual(self, qmeta: np.ndarray, rmeta: np.ndarray,
                      h0: np.ndarray, prev: np.ndarray, w: int,
                      pen_clip: int):
        """Fused band-retry interface: one packed H2D table, both band
        rounds + acceptance on the device (bsw_meta_dual), one D2H copy.
        Returns seven (n,) int32 arrays: the six DP results of the
        accepted round + the accepted round index."""
        opt = self.opt
        n = len(h0)
        if n == 0:
            z = np.zeros(0, np.int32)
            return (z,) * 7
        t0 = time.perf_counter()
        qflat, L = self._qctx
        qmeta = self._remap(qmeta)
        qlens = qmeta[:, 2].astype(np.int32)
        tlens = rmeta[:, 1].astype(np.int32)
        wide = self.dfi.dtype == torch.int64
        res = np.zeros((n, 7), np.int32)
        for Q, cls in _q_classes(qlens):
            m = len(cls)
            order = cls[np.argsort(tlens[cls], kind="stable")]
            P = _bucket(m, bsw_cuda.LT)
            T = _bucket(int(tlens[order].max(initial=1)), 128)
            s16 = self._use16(Q, int(h0[order].max(initial=0)))
            meta = np.zeros((P, 12), np.int32)
            meta[:m, 0:4] = qmeta[order]
            r0 = rmeta[order, 0]
            meta[:m, 4] = (r0 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
            meta[:m, 5] = (r0 >> 32).astype(np.int32)
            meta[:m, 6] = tlens[order]
            meta[:, 7] = 1
            meta[:m, 7] = h0[order]
            meta[:, 8] = -2              # pad lanes: accept at round 0
            meta[:m, 8] = prev[order]
            meta[:m, 9] = self._bands(qlens[order], w, pen_clip)
            meta[:m, 10] = self._bands(qlens[order], w * 2, pen_clip)
            t1 = time.perf_counter()
            out_dev = bsw_meta_dual(
                self.mat, qflat, self.dfi.pac_words,
                _t(meta, self.device), Q=Q, T=T, L=L,
                l_pac=self.dfi.l_pac, o_del=opt.o_del, e_del=opt.e_del,
                o_ins=opt.o_ins, e_ins=opt.e_ins, zdrop=opt.zdrop,
                w0=int(w), wide_r0=wide, state16=s16)
            t2 = time.perf_counter()
            out = out_dev.cpu().numpy()
            t3 = time.perf_counter()
            res[order] = out[:m, :7]
            for key, dt in (("engine_pack", t1 - t0),
                            ("engine_call", t2 - t1),
                            ("engine_fetch", t3 - t2)):
                self.prof[key] = self.prof.get(key, 0.0) + dt
            t0 = time.perf_counter()
        # each result crosses a raw ctypes pointer: must be C-contiguous
        return tuple(np.ascontiguousarray(res[:, j]) for j in range(7))

    def _run_kernel(self, qbuf, qoff, rbuf, roff, h0, w: int,
                    pen_clip: int):
        """Flat pairs -> per-Q-class padded tiles -> the DP."""
        opt = self.opt
        n = len(h0)
        dev = self.device
        qlens = (qoff[1:] - qoff[:-1]).astype(np.int32)
        tlens = (roff[1:] - roff[:-1]).astype(np.int32)
        Qall = _bucket(int(qlens.max(initial=1)), 128)
        Tall = _bucket(int(tlens.max(initial=1)), 128)
        q_all, _ = _pack_rows(qbuf, qoff, n, Qall)
        t_all, _ = _pack_rows(rbuf, roff, n, Tall)
        res = np.zeros((n, 6), np.int32)
        for Q, cls in _q_classes(qlens):
            m = len(cls)
            order = cls[np.argsort(tlens[cls], kind="stable")]
            P = _bucket(m, bsw_cuda.LT)
            T = _bucket(int(tlens[order].max(initial=1)), 128)
            s16 = self._use16(Q, int(h0[order].max(initial=0)))
            queries = np.full((P, Q), 4, np.int8)
            targets = np.full((P, T), 4, np.int8)
            queries[:m] = q_all[order, :Q].astype(np.int8)
            targets[:m] = t_all[order, :T].astype(np.int8)
            qlp = np.zeros((P, 1), np.int32)
            qlp[:m, 0] = qlens[order]
            tlp = np.zeros((P, 1), np.int32)
            tlp[:m, 0] = tlens[order]
            h0p = np.ones((P, 1), np.int32)
            h0p[:m, 0] = h0[order]
            ws = np.full((P, 1), w, np.int32)
            ws[:m, 0] = self._bands(qlens[order], w, pen_clip)
            out = bsw_cuda.bsw_extend_tiles(
                self.mat, _t(queries, dev), _t(qlp, dev), _t(targets, dev),
                _t(tlp, dev), _t(h0p, dev), _t(ws, dev), o_del=opt.o_del,
                e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
                zdrop=opt.zdrop, state16=s16).cpu().numpy()
            res[order] = out[:m, :6]
        # C-contiguous per result — consumed through a raw ctypes pointer
        return tuple(np.ascontiguousarray(res[:, j]) for j in range(6))

    def __call__(self, pairs, w: int, pen_clip: int):
        if not pairs:
            return []
        qoff = np.zeros(len(pairs) + 1, np.int64)
        roff = np.zeros(len(pairs) + 1, np.int64)
        np.cumsum([len(sp.qs) for sp in pairs], out=qoff[1:])
        np.cumsum([len(sp.rs) for sp in pairs], out=roff[1:])
        qbuf = np.concatenate([sp.qs for sp in pairs]) if qoff[-1] else \
            np.zeros(0, np.uint8)
        rbuf = np.concatenate([sp.rs for sp in pairs]) if roff[-1] else \
            np.zeros(0, np.uint8)
        h0 = np.array([sp.h0 for sp in pairs], np.int32)
        arrs = self.run_flat(qbuf, qoff, rbuf, roff, h0, w, pen_clip)
        return [tuple(int(a[i]) for a in arrs) for i in range(len(pairs))]


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)
