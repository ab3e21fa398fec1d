"""ctypes bindings for the native host tail (csrc/compseed_host.cpp).

The library is built on demand with g++ from the C++ sources at the
repository root and cached under build/compseed_tpu_torch/.  It owns
chaining → SeqPair emission → acceptance → purge → dedup → SAM; the DP
rounds in the middle run on the card through the provided engine.
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess

import numpy as np

from compseed_tpu_torch.index.fmindex import FMIndex
from compseed_tpu_torch.options import MemOptions

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "csrc", "compseed_host.cpp")
_SRC_SAIS = os.path.join(_ROOT, "csrc", "sais.cpp")
_SRC_BWTINC = os.path.join(_ROOT, "csrc", "bwtinc.cpp")
_BUILD = os.path.join(_ROOT, "build", "compseed_tpu_torch")
_SO = os.path.join(_BUILD, "libcompseed_host.so")


class CsOpt(ct.Structure):
    _fields_ = [
        ("a", ct.c_int32), ("b", ct.c_int32),
        ("o_del", ct.c_int32), ("e_del", ct.c_int32),
        ("o_ins", ct.c_int32), ("e_ins", ct.c_int32),
        ("pen_unpaired", ct.c_int32),
        ("pen_clip5", ct.c_int32), ("pen_clip3", ct.c_int32),
        ("w", ct.c_int32), ("zdrop", ct.c_int32),
        ("max_mem_intv", ct.c_int64),
        ("T", ct.c_int32), ("flag", ct.c_int32),
        ("min_seed_len", ct.c_int32), ("min_chain_weight", ct.c_int32),
        ("max_chain_extend", ct.c_int32),
        ("split_factor", ct.c_float),
        ("split_width", ct.c_int32), ("max_occ", ct.c_int32),
        ("max_chain_gap", ct.c_int32),
        ("mask_level", ct.c_float), ("drop_ratio", ct.c_float),
        ("XA_drop_ratio", ct.c_float), ("mask_level_redun", ct.c_float),
        ("mapQ_coef_len", ct.c_float), ("mapQ_coef_fac", ct.c_int32),
        ("max_ins", ct.c_int32), ("max_matesw", ct.c_int32),
        ("max_XA_hits", ct.c_int32), ("max_XA_hits_alt", ct.c_int32),
        ("mat", ct.c_int8 * 25),
    ]


def _to_csopt(opt: MemOptions) -> CsOpt:
    c = CsOpt()
    for name in ("a", "b", "o_del", "e_del", "o_ins", "e_ins",
                 "pen_unpaired", "pen_clip5", "pen_clip3", "w", "zdrop",
                 "max_mem_intv", "T", "flag", "min_seed_len",
                 "min_chain_weight", "max_chain_extend", "split_factor",
                 "split_width", "max_occ", "max_chain_gap", "mask_level",
                 "drop_ratio", "XA_drop_ratio", "mask_level_redun",
                 "mapQ_coef_len", "mapQ_coef_fac", "max_ins", "max_matesw",
                 "max_XA_hits", "max_XA_hits_alt"):
        setattr(c, name, getattr(opt, name))
    for i, v in enumerate(opt.mat):
        c.mat[i] = v
    return c


def build_library(force: bool = False) -> str:
    os.makedirs(_BUILD, exist_ok=True)
    src_mtime = max(os.path.getmtime(_SRC), os.path.getmtime(_SRC_SAIS),
                    os.path.getmtime(_SRC_BWTINC))
    if force or not os.path.exists(_SO) or \
            os.path.getmtime(_SO) < src_mtime:
        # compile to a temp path then atomically rename: another live
        # process may have the old .so mmapped, and `g++ -o` truncates
        # in place (SIGBUS for that process); rename keeps its inode
        tmp = f"{_SO}.tmp.{os.getpid()}"
        cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-pthread",
               "-o", tmp, _SRC, _SRC_SAIS, _SRC_BWTINC]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, _SO)
    return _SO


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ct.CDLL(build_library())
    i64p = ct.POINTER(ct.c_int64)
    i32p = ct.POINTER(ct.c_int32)
    u8p = ct.POINTER(ct.c_uint8)
    lib.cs_batch_create.restype = ct.c_void_p
    lib.cs_batch_create.argtypes = [
        ct.POINTER(CsOpt), u8p, ct.c_int64, i64p, i32p, u8p, ct.c_int32,
        ct.c_char_p, ct.c_int32, u8p, i64p, i64p, i64p, i64p,
        ct.c_int32]
    lib.cs_export_pair_meta.restype = ct.c_int64
    lib.cs_export_pair_meta.argtypes = [ct.c_void_p, ct.c_int32, i32p,
                                        i64p, i32p, i32p]
    lib.cs_apply_dual.restype = None
    lib.cs_apply_dual.argtypes = [ct.c_void_p, ct.c_int32,
                                  ct.c_int32] + [i32p] * 6
    lib.cs_pending_pairs.restype = ct.c_int64
    lib.cs_pending_pairs.argtypes = [ct.c_void_p, ct.c_int32]
    lib.cs_pair_buf_sizes.restype = ct.c_int64
    lib.cs_pair_buf_sizes.argtypes = [ct.c_void_p, ct.c_int32, i64p, i64p]
    lib.cs_export_pairs.restype = ct.c_int64
    lib.cs_export_pairs.argtypes = [ct.c_void_p, ct.c_int32, u8p, i64p,
                                    u8p, i64p, i32p]
    lib.cs_apply_round.restype = None
    lib.cs_apply_round.argtypes = [ct.c_void_p, ct.c_int32, ct.c_int32,
                                   ct.c_int32] + [i32p] * 6
    lib.cs_finalize.restype = None
    lib.cs_finalize.argtypes = [ct.c_void_p, ct.c_int64, ct.c_char_p, i64p,
                                ct.c_char_p, i64p, ct.c_char_p, i64p,
                                ct.c_char_p]
    lib.cs_finalize_pe.restype = None
    lib.cs_finalize_pe.argtypes = [ct.c_void_p, ct.c_int64, ct.c_char_p,
                                   i64p, ct.c_char_p, i64p, ct.c_char_p,
                                   i64p, ct.c_char_p,
                                   ct.POINTER(ct.c_double)]
    lib.cs_sam_len.restype = ct.c_int64
    lib.cs_sam_len.argtypes = [ct.c_void_p, ct.c_int32]
    lib.cs_sam_copy.restype = None
    lib.cs_sam_copy.argtypes = [ct.c_void_p, ct.c_int32, ct.c_char_p]
    lib.cs_sam_total.restype = ct.c_int64
    lib.cs_sam_total.argtypes = [ct.c_void_p, i64p]
    lib.cs_sam_copy_all.restype = None
    lib.cs_sam_copy_all.argtypes = [ct.c_void_p, ct.c_char_p]
    lib.cs_batch_destroy.restype = None
    lib.cs_batch_destroy.argtypes = [ct.c_void_p]
    lib.cs_sais_u8.restype = ct.c_int
    lib.cs_sais_u8.argtypes = [u8p, ct.c_int64, ct.c_int64, i64p]
    u64p = ct.POINTER(ct.c_uint64)
    lib.cs_bwt_merge_block.restype = ct.c_int
    lib.cs_bwt_merge_block.argtypes = [u8p, ct.c_int64, ct.c_int64,
                                       u8p, ct.c_int64, u8p, i64p]
    lib.cs_bwt_cal_sa.restype = ct.c_int
    lib.cs_bwt_cal_sa.argtypes = [u8p, ct.c_int64, ct.c_int64,
                                  ct.c_int32, u64p]
    lib.cs_set_threads.restype = None
    lib.cs_set_threads.argtypes = [ct.c_int32]
    _lib = lib
    return lib


def set_threads(n: int) -> None:
    """Thread count for the host tail's kt_for fan-outs
    (cstl/kthread.c:51-63 equivalent); results are identical for any
    value."""
    _load().cs_set_threads(int(n))


def _ptr(a: np.ndarray, typ):
    # the native side indexes these densely; a strided view (e.g. a
    # column of a 2-D result) would be read as scrambled memory — the
    # bug behind a SAM corruption seen when a DP engine returned
    # res[:, j] views instead of copies
    if not a.flags.c_contiguous:
        raise ValueError("non-contiguous array passed to native code")
    return a.ctypes.data_as(ct.POINTER(typ))


MAX_BAND_TRY = 2


class NativeTail:
    """Runs the post-SAL tail for one batch through the native library."""

    def __init__(self, opt: MemOptions, fm: FMIndex):
        self.lib = _load()
        self.opt = opt
        self.copt = _to_csopt(opt)
        self.fm = fm
        # host-tail phase timers (display_profile-grade, main.cpp:203-214):
        # chain = cs_batch_create (chaining/filter/SeqPair emission),
        # export/apply = pair metadata marshalling, engine = device BSW
        # incl. its D2H sync, finalize = dedup/mapq/SAM build, sam = copy
        self.prof: dict[str, float] = {}
        self.pac = np.ascontiguousarray(fm.pac)
        self.ann_off = np.array([a.offset for a in fm.bns.anns],
                                dtype=np.int64)
        self.ann_len = np.array([a.length for a in fm.bns.anns],
                                dtype=np.int32)
        self.ann_alt = np.array([a.is_alt for a in fm.bns.anns],
                                dtype=np.uint8)
        self.names = b"".join(a.name.encode() + b"\x00" for a in fm.bns.anns)

    def run_batch(self, queries, matches_per_read, seeds_per_read, engine,
                  n_processed: int, names, quals, comments,
                  rg_id: str = "", paired: bool = False) -> list[str]:
        from compseed_tpu_torch.pipeline.chain import l_rep_one
        R = len(queries)
        lrep = np.array(
            [l_rep_one([(beg, end, s) for (k, l, s, beg, end) in ms],
                       self.opt.max_occ) for ms in matches_per_read],
            dtype=np.int64).reshape(R)
        s_counts = [len(s) for s in seeds_per_read]
        soff = np.zeros(R + 1, dtype=np.int64)
        np.cumsum(s_counts, out=soff[1:])
        sflat = np.zeros((int(soff[-1]), 3), dtype=np.int64)
        i = 0
        for ss in seeds_per_read:
            for s in ss:
                sflat[i] = (s.rbeg, s.qbeg, s.len)
                i += 1
        return self.run_batch_flat(queries, lrep, sflat, soff,
                                   engine, n_processed, names, quals,
                                   comments, rg_id, paired=paired)

    def run_batch_flat(self, queries, lrep, sflat, soff, engine,
                       n_processed: int, names, quals, comments,
                       rg_id: str = "", paired: bool = False,
                       pes_override=None) -> list[str]:
        """``lrep`` is the per-read repetitive-coverage length (the only
        chaining input derived from the match list, comp_seed.cpp:271-281)
        — the full matches never leave the device."""
        lib = self.lib
        R = len(queries)
        qbuf = np.concatenate(queries) if R else np.zeros(0, np.uint8)
        qoff = np.zeros(R + 1, dtype=np.int64)
        np.cumsum([len(q) for q in queries], out=qoff[1:])
        lrep = np.ascontiguousarray(lrep, dtype=np.int64)
        sflat = np.ascontiguousarray(sflat, dtype=np.int64)
        soff = np.ascontiguousarray(soff, dtype=np.int64)

        import time as _time

        def _tick(key, t0):
            t1 = _time.perf_counter()
            self.prof[key] = self.prof.get(key, 0.0) + (t1 - t0)
            return t1

        use_meta = bool(getattr(engine, "supports_meta", False))
        use_dual = use_meta and bool(getattr(engine, "supports_meta_dual",
                                             False))
        _t = _time.perf_counter()
        h = lib.cs_batch_create(
            ct.byref(self.copt), _ptr(self.pac, ct.c_uint8),
            self.fm.l_pac, _ptr(self.ann_off, ct.c_int64),
            _ptr(self.ann_len, ct.c_int32), _ptr(self.ann_alt, ct.c_uint8),
            len(self.fm.bns.anns), self.names, R,
            _ptr(qbuf, ct.c_uint8), _ptr(qoff, ct.c_int64),
            _ptr(lrep, ct.c_int64),
            _ptr(sflat, ct.c_int64), _ptr(soff, ct.c_int64),
            1 if use_meta else 0)
        _t = _tick("chain", _t)
        try:
            for side, pen in ((0, self.opt.pen_clip5),
                              (1, self.opt.pen_clip3)):
                if use_dual:
                    # fused path: one export, one device program running
                    # both band rounds + acceptance, one apply — two host
                    # round trips per chunk instead of up to eight
                    n = lib.cs_pending_pairs(h, side)
                    if n == 0:
                        # still resolve the side-1 h0 contract
                        lib.cs_export_pair_meta(h, side, None, None, None,
                                                None)
                        continue
                    qmeta = np.zeros((n, 4), np.int32)
                    rmeta = np.zeros((n, 2), np.int64)
                    h0 = np.zeros(n, np.int32)
                    prev = np.zeros(n, np.int32)
                    lib.cs_export_pair_meta(h, side,
                                            _ptr(qmeta, ct.c_int32),
                                            _ptr(rmeta, ct.c_int64),
                                            _ptr(h0, ct.c_int32),
                                            _ptr(prev, ct.c_int32))
                    _t = _tick("export", _t)
                    res = engine.run_meta_dual(qmeta, rmeta, h0, prev,
                                               self.opt.w, pen)
                    _t = _tick("engine", _t)
                    lib.cs_apply_dual(h, side, self.opt.w,
                                      *[_ptr(a, ct.c_int32)
                                        for a in (res[0], res[1], res[2],
                                                  res[3], res[4], res[6])])
                    _t = _tick("apply", _t)
                    continue
                for rnd in range(MAX_BAND_TRY):
                    w = self.opt.w << rnd
                    last = 1 if rnd + 1 == MAX_BAND_TRY else 0
                    if use_meta:
                        n = lib.cs_pending_pairs(h, side)
                        if n == 0:
                            break
                        qmeta = np.zeros((n, 4), np.int32)
                        rmeta = np.zeros((n, 2), np.int64)
                        h0 = np.zeros(n, np.int32)
                        lib.cs_export_pair_meta(h, side,
                                                _ptr(qmeta, ct.c_int32),
                                                _ptr(rmeta, ct.c_int64),
                                                _ptr(h0, ct.c_int32), None)
                        _t = _tick("export", _t)
                        res = engine.run_meta(qmeta, rmeta, h0, w, pen)
                        _t = _tick("engine", _t)
                        lib.cs_apply_round(h, side, w, last,
                                           *[_ptr(a, ct.c_int32)
                                             for a in res])
                        _t = _tick("apply", _t)
                        continue
                    mq = ct.c_int64()
                    mr = ct.c_int64()
                    n = lib.cs_pair_buf_sizes(h, side, ct.byref(mq),
                                              ct.byref(mr))
                    if n == 0:
                        break
                    qb = np.zeros(max(int(mq.value), 1), np.uint8)
                    rb = np.zeros(max(int(mr.value), 1), np.uint8)
                    qo = np.zeros(n + 1, np.int64)
                    ro = np.zeros(n + 1, np.int64)
                    h0 = np.zeros(n, np.int32)
                    lib.cs_export_pairs(h, side, _ptr(qb, ct.c_uint8),
                                        _ptr(qo, ct.c_int64),
                                        _ptr(rb, ct.c_uint8),
                                        _ptr(ro, ct.c_int64),
                                        _ptr(h0, ct.c_int32))
                    _t = _tick("export", _t)
                    res = engine_flat(engine, qb, qo, rb, ro, h0, w, pen)
                    _t = _tick("engine", _t)
                    lib.cs_apply_round(h, side, w, last,
                                       *[_ptr(a, ct.c_int32) for a in res])
                    _t = _tick("apply", _t)

            _t = _time.perf_counter()
            name_buf = b"".join(n.encode() for n in names)
            name_off = np.zeros(R + 1, np.int64)
            np.cumsum([len(n.encode()) for n in names], out=name_off[1:])
            if any(q for q in quals):
                qual_buf = b"".join((q or "").encode() for q in quals)
                qual_off = np.zeros(R + 1, np.int64)
                np.cumsum([len((q or "").encode()) for q in quals],
                          out=qual_off[1:])
                qoff_p = _ptr(qual_off, ct.c_int64)
            else:
                qual_buf = b""
                qoff_p = None
            if any(c for c in comments):
                com_buf = b"".join((c or "").encode() for c in comments)
                com_off = np.zeros(R + 1, np.int64)
                np.cumsum([len((c or "").encode()) for c in comments],
                          out=com_off[1:])
                coff_p = _ptr(com_off, ct.c_int64)
            else:
                com_buf = b""
                coff_p = None
            if paired:
                pes_p = None
                if pes_override is not None:
                    pes_arr = np.ascontiguousarray(pes_override,
                                                   dtype=np.float64)
                    pes_p = pes_arr.ctypes.data_as(ct.POINTER(ct.c_double))
                lib.cs_finalize_pe(h, n_processed, name_buf,
                                   _ptr(name_off, ct.c_int64), qual_buf,
                                   qoff_p, com_buf, coff_p,
                                   rg_id.encode() if rg_id else None,
                                   pes_p)
            else:
                lib.cs_finalize(h, n_processed, name_buf,
                                _ptr(name_off, ct.c_int64), qual_buf, qoff_p,
                                com_buf, coff_p,
                                rg_id.encode() if rg_id else None)
            _t = _tick("finalize", _t)
            # one bulk copy instead of 2 ctypes calls per read
            # (32k calls/chunk was ~50 ms of pure call overhead);
            # latin-1 round-trips any byte: a corrupt record must surface
            # as a diagnosable SAM line, not a UnicodeDecodeError here
            off = np.zeros(R + 1, dtype=np.int64)
            total = lib.cs_sam_total(h, _ptr(off, ct.c_int64))
            buf = ct.create_string_buffer(max(int(total), 1))
            lib.cs_sam_copy_all(h, buf)
            raw = buf.raw
            out = [raw[off[r]: off[r + 1]].decode("latin-1")
                   for r in range(R)]
            _tick("sam_copy", _t)
            return out
        finally:
            lib.cs_batch_destroy(h)


def engine_flat(engine, qbuf, qoff, rbuf, roff, h0, w, pen):
    """Run flat pair buffers through the engine; returns six int32 arrays."""
    if hasattr(engine, "run_flat"):
        return engine.run_flat(qbuf, qoff, rbuf, roff, h0, w, pen)
    from compseed_tpu_torch.pipeline.extension import SeqPair
    n = len(h0)
    pairs = [SeqPair(qs=qbuf[qoff[i]:qoff[i + 1]],
                     rs=rbuf[roff[i]:roff[i + 1]],
                     h0=int(h0[i]), seqid=0, regid=i) for i in range(n)]
    res = engine(pairs, w, pen)
    arrs = [np.zeros(n, np.int32) for _ in range(6)]
    for i, tup in enumerate(res):
        for j in range(6):
            arrs[j][i] = tup[j]
    return arrs


def suffix_array_native(s: "np.ndarray", k: int = 5) -> "np.ndarray":
    """SA-IS suffix array of s + sentinel (csrc/sais.cpp); same contract
    as compseed_tpu_torch.index.suffix.suffix_array but linear time and 64-bit,
    so whole-genome construction fits this host's RAM."""
    lib = _load()
    s = np.ascontiguousarray(s, dtype=np.uint8)
    sa = np.empty(len(s) + 1, dtype=np.int64)
    rc = lib.cs_sais_u8(_ptr(s, ct.c_uint8), len(s), k + 1,
                        _ptr(sa, ct.c_int64))
    if rc != 0:
        raise RuntimeError("sais failed")
    return sa


def bwt_merge_block_native(bwt_packed: "np.ndarray", n: int, primary: int,
                           block: "np.ndarray") -> tuple["np.ndarray", int]:
    """Prepend `block` (nt4 codes 0..3) to the text whose $-removed BWT
    is `bwt_packed` (pack_pac layout, n chars).  Returns (new packed
    BWT of n+len(block) chars, new primary).  csrc/bwtinc.cpp — the
    low-memory twin of the reference's BWTIncConstruct
    (FM_index/bwt_gen.c:1299)."""
    lib = _load()
    m = len(block)
    out = np.zeros((n + m + 3) // 4, dtype=np.uint8)
    prim = np.zeros(1, dtype=np.int64)
    rc = lib.cs_bwt_merge_block(
        _ptr(np.ascontiguousarray(bwt_packed), ct.c_uint8), n, primary,
        _ptr(np.ascontiguousarray(block, dtype=np.uint8), ct.c_uint8), m,
        _ptr(out, ct.c_uint8), _ptr(prim, ct.c_int64))
    if rc != 0:
        raise RuntimeError(f"bwt_merge_block failed rc={rc}")
    return out, int(prim[0])


def bwt_cal_sa_native(bwt_packed: "np.ndarray", n: int, primary: int,
                      sa_intv: int) -> "np.ndarray":
    """Sampled suffix array from a finished BWT via the inverse-Psi
    walk (bwt_cal_sa, FM_index/bwt.c:62-84); sa[0] == 2**64-1."""
    lib = _load()
    n_sa = (n + sa_intv) // sa_intv
    out = np.zeros(n_sa, dtype=np.uint64)
    rc = lib.cs_bwt_cal_sa(
        _ptr(np.ascontiguousarray(bwt_packed), ct.c_uint8), n, primary,
        sa_intv, _ptr(out, ct.c_uint64))
    if rc != 0:
        raise RuntimeError(f"bwt_cal_sa failed rc={rc}")
    return out
