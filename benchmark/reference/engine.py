"""The plain reference of the engine cells: the fused calling step
(signatures -> clusters -> call statistics -> coverage, genotype and QC of
each candidate) written in NumPy from the step's semantics, on the CPU.

It shares no code with the port. The semantics are those of Sniffles2's
clustering and calling as the fused step states them: signatures sorted
by (svtype, 100 bp bin, position); a seed a bin; neighbouring clusters of
one svtype merged, all at once and round after round (at most 32, until a
round merges nothing), where the gap between their bins is within
cluster_r times the smaller start stdev, or, where either holds a repeat,
their span within cluster_repeat_h times their mean lengths (at most
cluster_repeat_h_max), or a BND's gap within cluster_merge_bnd; the
start stdev and mean length of a cluster over at most 100 of its leads
picked at a stride; each cluster resplit where its sorted 20 bp length
bins jump by more than max(minsvlen, cluster_merge_len x the smaller);
then per cluster the upper median of the most common values (within 2 of
the top count) of svlen and position, the stdev of the middle half,
the distinct reads, the mean mapq, the strands, the mean NM; the 5-point
coverage probes; the binomial genotype; the first failing QC filter.

Arithmetic is float32 where the step states float32. `flt` is the
rounding applied after each floating-point operation: float32 for the
reference, bfloat16 for the control (the precision below the
configuration's float32); the control's second form keeps the clustering
in float32 and rounds the statistics, genotype and QC to bfloat16.

    engine_step(sig, coverage, params, flt=f32) -> {key: array [n_clusters]}
"""
from __future__ import annotations

import numpy as np

BINSIZE = 100
RESPLIT_BINSIZE = 20
MERGE_ROUNDS_MAX = 32
INS, DEL, DUP, INV, BND, SINGLE_LEFT, SINGLE_RIGHT = range(7)

# QC filter codes in the step's enumeration (0 is PASS)
FILTERS = ("PASS", "STDEV_POS", "STDEV_LEN", "SINGLE_BREAK", "SVLEN_MIN", "STRAND_BND",
           "COV_CHANGE_DEL", "COV_CHANGE_DUP", "COV_CHANGE_INS", "SUPPORT_MIN",
           "COV_MIN_GT", "ALN_NM", "MOSAIC_VAF", "SVLEN_MAX_MOSAIC", "STRAND",
           "STRAND_MOSAIC", "SVLEN_MIN_MOSAIC", "COV_MIN", "NOT_MOSAIC_VAF", "GT",
           "GT_FAILED")
CODE = {name: i for i, name in enumerate(FILTERS)}

INT_KEYS = ("svtype", "svlen", "pos", "end", "raw_pos_center", "pos_min", "pos_max",
            "support", "lead_count", "qual", "fwd", "rev", "n_strands",
            "coverage_upstream", "coverage_start", "coverage_center", "coverage_end",
            "coverage_downstream", "gt_a", "gt_b", "gq", "zscore", "dr", "dv", "filter_code")
FLOAT_KEYS = ("stdev_pos", "stdev_len", "nm", "af", "coverage")
BOOL_KEYS = ("gt_failed", "qc", "precise", "cluster_valid")


def f32(x):
    return np.asarray(x, dtype=np.float32)


def bf16(x):
    """Rounded to bfloat16 (to nearest, ties to even), held in float32."""
    a = np.atleast_1d(np.asarray(x, dtype=np.float32)).copy()
    bits = a.view(np.uint32)
    finite = np.isfinite(a)
    rounded = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    bits[finite] = rounded[finite]
    return a.reshape(np.shape(x))


def default_params(call: dict) -> dict:
    """The step's parameters at Sniffles2's defaults, with the
    configuration's call parameters (`minsupport`, `minsvlen`,
    `cluster_r`) and `coverage_global` laid over them."""
    p = {"cluster_r": 2.5, "cluster_repeat_h": 1.5, "cluster_repeat_h_max": 1000.0,
         "cluster_merge_bnd": 1000, "cluster_merge_len": 0.22, "minsvlen": 50,
         "minsvlen_screen": 45, "minsvlen_hard_cap": 1,
         "genotype_error": 0.05, "ploidy": 2.0, "normalization_target": 250.0,
         "genotype_min_z_score": 5.0, "long_ins_length": 2500.0, "rescale_base": 1.66,
         "rescale_mult": 0.33, "detect_large_ins": 1,
         "qc_stdev": 1, "qc_stdev_abs_max": 500.0, "qc_strand": 0, "qc_bnd_filter_strand": 1,
         "qc_coverage": 1.0, "long_del_length": 50000.0, "long_del_coverage": 0.66,
         "long_dup_length": 50000.0, "long_dup_coverage": 1.33, "long_inv_length": 10000.0,
         "dev_longer_del": 200000.0, "dev_longer_dup": 200000.0, "qc_nm": 0,
         "qc_nm_threshold": 0.0, "qc_nm_mult": 1.66, "dev_min_dup_vaf": 1 / 6.0,
         "minsupport_auto_base": 1.5, "minsupport_auto_mult": 0.1,
         "minsupport_auto_regional_coverage_weight": 0.75, "coverage_global": 30.0,
         "mosaic": 0, "mosaic_af_min": 0.05, "mosaic_af_max": 0.218, "mosaic_min_reads": 3.0,
         "mosaic_use_strand_thresholds": 10.0, "mosaic_qc_strand": 1,
         "mosaic_qc_invdup_min_length": 500.0, "max_svlen_mosaic": 50000.0,
         "mosaic_include_germline": 0}
    minsupport = str(call.get("minsupport", "3"))
    p["minsupport_is_auto"] = int(minsupport == "auto")
    p["minsupport_const"] = 0.0 if minsupport == "auto" else float(minsupport)
    p["minsvlen"] = int(call.get("minsvlen", p["minsvlen"]))
    p["cluster_r"] = float(call.get("cluster_r", p["cluster_r"]))
    return p


# --- runs of equal keys in a sorted array ----------------------------------

def _heads(*cols) -> np.ndarray:
    """True where any column changes from the element before (first True)."""
    n = cols[0].shape[0]
    head = np.zeros(n, dtype=bool)
    if n:
        head[0] = True
        for c in cols:
            head[1:] |= c[1:] != c[:-1]
    return head


def _sum(x, starts, flt):
    """Each run's sum, added in float64 and rounded once."""
    return flt(np.add.reduceat(np.asarray(x, dtype=np.float64), starts))


def _counts(starts, n) -> np.ndarray:
    return np.diff(np.append(starts, n))


# --- clustering --------------------------------------------------------------

def _metrics(seg_starts, pos, svlen, flt):
    """Each cluster's mean length and start stdev over at most 100 leads
    picked at a stride L // min(L, 100), the mean length divided by
    min(L, 100) and the stdev the sample stdev of the picks."""
    n = pos.shape[0]
    L = _counts(seg_starts, n)
    seg = np.repeat(np.arange(L.shape[0]), L)
    p = np.arange(n) - seg_starts[seg]
    nn = np.minimum(L, 100)
    stride = np.maximum(L // np.maximum(nn, 1), 1)
    pick = p % stride[seg] == 0
    npicks = np.add.reduceat(pick.astype(np.int64), seg_starts)
    posf = flt(pos)
    svlenf = flt(svlen)
    mean_svlen = flt(_sum(np.where(pick, svlenf, 0), seg_starts, flt) / flt(np.maximum(nn, 1)))
    mean_start = flt(_sum(np.where(pick, posf, 0), seg_starts, flt)
                     / flt(np.maximum(npicks, 1)))
    dev = flt(posf - mean_start[seg])
    ss = _sum(np.where(pick, flt(dev * dev), 0), seg_starts, flt)
    sd = flt(np.sqrt(flt(ss / flt(np.maximum(npicks - 1, 1)))))
    return mean_svlen, np.where(npicks >= 2, sd, flt(0))


def cluster(sig: dict, params: dict, flt=f32) -> dict:
    """The batch's valid signatures in cluster order, with each one's
    cluster id: {column: array [m]} and "cluster_id"."""
    keep = np.asarray(sig["valid"], dtype=bool)
    s = {k: np.asarray(v)[keep] for k, v in sig.items() if k != "valid"}
    order = np.lexsort((s["pos"], s["pos"] // BINSIZE, s["svtype"]))
    s = {k: v[order] for k, v in s.items()}
    n = s["pos"].shape[0]
    pos, svtype = s["pos"].astype(np.int64), s["svtype"]
    bin_ = pos // BINSIZE
    boundary = _heads(svtype, bin_)

    r = flt(params["cluster_r"])
    h = flt(params["cluster_repeat_h"])
    h_max = flt(params["cluster_repeat_h_max"])
    for _ in range(MERGE_ROUNDS_MAX):
        starts = np.flatnonzero(boundary)
        start_bp = np.minimum.reduceat(bin_ * BINSIZE, starts)
        end_bp = np.maximum.reduceat(bin_ * BINSIZE + BINSIZE, starts)
        mean_svlen, sd = _metrics(starts, pos, s["svlen"], flt)
        repeat = np.maximum.reduceat(s["repeat"].astype(np.int8), starts) > 0
        # segment g >= 1 against segment g - 1
        inner = start_bp[1:] - end_bp[:-1]
        outer = end_bp[1:] - start_bp[:-1]
        near = flt(inner) <= flt(np.minimum(sd[1:], sd[:-1]) * r)
        h_lim = np.minimum(h_max, flt(flt(np.abs(mean_svlen[1:]) + np.abs(mean_svlen[:-1])) * h))
        in_repeat = (repeat[1:] | repeat[:-1]) & (flt(outer) <= h_lim)
        heads = starts[1:]
        bnd = (svtype[heads] == BND) & (inner <= params["cluster_merge_bnd"])
        merge = (svtype[heads] == svtype[heads - 1]) & (near | in_repeat | bnd)
        if not merge.any():
            break
        boundary[heads[merge]] = False

    seg = np.cumsum(boundary) - 1
    svbin = (np.abs(s["svlen"]) // RESPLIT_BINSIZE) * RESPLIT_BINSIZE
    order = np.lexsort((svbin, seg))
    s = {k: v[order] for k, v in s.items()}
    seg, svbin = seg[order], svbin[order]
    split = _heads(seg)
    prev_bin = np.concatenate([svbin[:1], svbin[:-1]])
    gap = flt(np.abs(svbin - prev_bin))
    thr = np.maximum(flt(params["minsvlen"]),
                     flt(flt(np.minimum(svbin, prev_bin)) * flt(params["cluster_merge_len"])))
    split |= (gap > thr) & (s["svtype"] != BND)
    s["cluster_id"] = np.cumsum(split) - 1
    return s


# --- per-cluster statistics ----------------------------------------------------

def _sorted_within(cid, values):
    """(values sorted within each cluster, the cluster's start of each run
    of equal values, the run starts)."""
    order = np.lexsort((values, cid))
    v, c = values[order], cid[order]
    return v, c, np.flatnonzero(_heads(c, v))


def _median_modes(cid, values, n_clusters):
    """The upper median of the distinct values whose count is within 2 of
    the cluster's top count."""
    v, c, runs = _sorted_within(cid, values)
    count = _counts(runs, v.shape[0])
    rc = c[runs]
    top = np.zeros(n_clusters, dtype=np.int64)
    np.maximum.at(top, rc, count)
    kept = top[rc] - count < 3
    kc = rc[kept]
    kv = v[runs][kept]
    n_kept = np.bincount(kc, minlength=n_clusters)
    first = np.concatenate([[0], np.cumsum(n_kept)[:-1]])
    return kv[first + n_kept // 2]


def _trimmed_stdev(cid, values, n_clusters, flt):
    """The sample stdev of each cluster's sorted values with 25 % (rounded
    down) dropped from each end, on values less the window's least, as
    s2 - (n x mean) x mean rounded once."""
    v, c, _ = _sorted_within(cid, values)
    cnt = np.bincount(c, minlength=n_clusters)
    first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    rank = np.arange(v.shape[0]) - first[c]
    trim = cnt * 25 // 100
    win = (rank >= trim[c]) & (rank < (cnt - trim)[c])
    wc, wv = c[win], v[win].astype(np.int64)
    k = np.bincount(wc, minlength=n_clusters)
    shift = np.full(n_clusters, np.iinfo(np.int64).max)
    np.minimum.at(shift, wc, wv)
    x = flt(wv - shift[wc])
    s1 = flt(np.bincount(wc, weights=x.astype(np.float64), minlength=n_clusters))
    s2 = flt(np.bincount(wc, weights=flt(x * x).astype(np.float64), minlength=n_clusters))
    kf = flt(k)
    mean = flt(s1 / flt(np.maximum(k, 1)))
    t = flt(kf * mean)
    num = flt(s2.astype(np.float64) - t.astype(np.float64) * mean.astype(np.float64))
    var = np.maximum(flt(num / flt(np.maximum(k - 1, 1))), flt(0))
    return np.where(k >= 2, flt(np.sqrt(var)), flt(0))


def statistics(s: dict, flt=f32) -> dict:
    cid = s["cluster_id"]
    nc = int(cid[-1]) + 1 if cid.shape[0] else 0
    starts = np.flatnonzero(_heads(cid))
    count = _counts(starts, cid.shape[0])
    svlen_c = _median_modes(cid, s["svlen"].astype(np.int64), nc)
    pos_c = _median_modes(cid, s["pos"].astype(np.int64), nc)
    _, read_cid, read_runs = _sorted_within(cid, s["read_id"].astype(np.int64))
    support = np.bincount(read_cid[read_runs], minlength=nc)
    fwd = np.add.reduceat((s["strand"] > 0).astype(np.int64), starts)
    svtype = np.maximum.reduceat(s["svtype"], starts)
    is_del, is_ins = svtype == DEL, svtype == INS
    return {
        "svtype": svtype,
        "svlen": svlen_c,
        "pos": np.where(is_del, pos_c + svlen_c, pos_c),
        "end": np.where(is_ins | is_del, pos_c, pos_c + np.abs(svlen_c)),
        "raw_pos_center": pos_c,
        "pos_min": np.minimum.reduceat(s["pos"], starts),
        "pos_max": np.maximum.reduceat(s["pos"], starts),
        "stdev_pos": _trimmed_stdev(cid, s["pos"].astype(np.int64), nc, flt),
        "stdev_len": _trimmed_stdev(cid, s["svlen"].astype(np.int64), nc, flt),
        "support": support,
        "lead_count": count,
        "qual": np.floor(flt(_sum(s["mapq"], starts, flt) / flt(count))).astype(np.int64),
        "fwd": fwd,
        "rev": count - fwd,
        "n_strands": np.where((fwd > 0) & (count - fwd > 0), 2, 1),
        "nm": flt(_sum(flt(s["nm"]), starts, flt) / flt(count)),
        "support_sa": np.add.reduceat(s["sa"].astype(np.int64), starts),
    }


# --- the candidate's coverage, genotype and QC ----------------------------------

def coverage_probes(coverage, st: dict, updown_bins: int = 5) -> dict:
    """Coverage at five points of each candidate (0 outside the array)."""
    cov = np.asarray(coverage)
    svtype, start = st["svtype"], st["pos"].astype(np.int64)
    end = np.where(svtype == INS, start + 1,
                   np.where(svtype == BND, start, start + np.abs(st["svlen"])))

    def at(i):
        ok = (i >= 0) & (i < cov.shape[0])
        return np.where(ok, cov[np.clip(i, 0, cov.shape[0] - 1)], 0).astype(np.int64)
    point = (svtype == INS) | (svtype == BND)
    return {"coverage_upstream": at(start - BINSIZE * updown_bins),
            "coverage_start": np.where(point, at(start - BINSIZE), at(start)),
            "coverage_center": np.where(point, at(start), at((start + end) // 2)),
            "coverage_end": np.where(point, at(end + BINSIZE), at(end - BINSIZE)),
            "coverage_downstream": at(end + BINSIZE * updown_bins)}


def _mean_nonzero(flt, *vals):
    """(round(mean of the non-zero values), none was non-zero)."""
    v = [flt(x) for x in vals]
    cnt = sum((x != 0).astype(np.int64) for x in v)
    total = v[0]
    for x in v[1:]:
        total = flt(total + x)
    return np.where(cnt > 0, np.round(flt(total / flt(np.maximum(cnt, 1)))), flt(0)), cnt == 0


def _rescaled(st, p, flt):
    """Support of a long insertion scaled up by base + mult x its length
    over long_ins_length, rounded."""
    svlen = flt(st["svlen"])
    long_ins = (st["svtype"] == INS) & (svlen >= flt(p["long_ins_length"]))
    scale = flt(flt(p["rescale_base"])
                + flt(flt(p["rescale_mult"]) * flt(svlen / flt(p["long_ins_length"]))))
    sup = flt(st["support"])
    return np.where(long_ins, np.round(flt(sup * scale)), sup)


def genotype(st: dict, cov: dict, p: dict, flt) -> dict:
    svtype = st["svtype"]
    supp = _rescaled(st, p, flt)
    c_s, c_c, c_e = cov["coverage_start"], cov["coverage_center"], cov["coverage_end"]
    default, f_default = _mean_nonzero(flt, c_s, c_c, c_e)
    ins, f_ins = _mean_nonzero(flt, c_c)
    dup, f_dup = _mean_nonzero(flt, c_s, c_e)
    dup = flt(dup + np.round(flt(flt(0.75) * supp)))
    inv, f_inv = _mean_nonzero(flt, cov["coverage_upstream"], cov["coverage_downstream"])
    inv = flt(inv + np.round(flt(flt(0.5) * supp)))
    sa = st["support_sa"]
    del_sa, f_del_sa = _mean_nonzero(flt, c_s + sa, c_c + sa, c_e + sa)
    dele = np.where(sa > 0, del_sa, default)
    f_del = np.where(sa > 0, f_del_sa, f_default)
    by_type = [(INS, ins, f_ins), (DUP, dup, f_dup), (INV, inv, f_inv), (DEL, dele, f_del)]
    coverage, failed = flt(default), f_default
    for t, c, f in by_type:
        coverage = np.where(svtype == t, c, coverage)
        failed = np.where(svtype == t, f, failed)
    coverage = flt(np.maximum(coverage, supp))
    af = flt(supp / np.maximum(coverage, flt(1)))
    target = flt(p["normalization_target"])
    top = np.maximum(supp, coverage)
    norm = np.where(top > target, flt(target / np.maximum(top, flt(1))), flt(1))
    k = np.round(flt(supp * norm))
    n = np.round(flt(coverage * norm))
    err = flt(p["genotype_error"])
    het = flt(flt(1) / flt(p["ploidy"]))

    def log10(x):
        return flt(np.log10(np.float64(x)))

    def ll(q):
        return flt(flt(k * log10(q)) + flt(flt(n - k) * log10(flt(flt(1) - q))))
    lq = np.stack([ll(err), ll(het), ll(flt(flt(1) - err))])
    order = np.argsort(-lq, axis=0, kind="stable")
    ranked = np.take_along_axis(lq, order, axis=0)
    l1, l2, lz = ranked[0], ranked[1], lq[0]
    under = -323.3
    gq = np.where(l2 < under, 0, np.minimum(60, np.trunc(flt(flt(-10) * flt(l2 - l1)))))
    z = np.where(lz < under, 0, np.minimum(60, np.trunc(flt(flt(-10) * flt(lz - l1)))))
    best = order[0]
    gt_b = (best >= 1).astype(np.int64)
    dup_vaf = (svtype == DUP) & (af >= flt(p["dev_min_dup_vaf"]))
    gt_b = np.where(dup_vaf & (best == 0), 1, gt_b)
    return {"gt_a": (best == 2).astype(np.int64), "gt_b": gt_b,
            "gq": gq.astype(np.int64), "zscore": z.astype(np.int64),
            "dv": supp.astype(np.int64), "dr": flt(coverage - supp).astype(np.int64),
            "af": af, "gt_failed": failed.astype(bool), "coverage": coverage}


def qc(st: dict, cov: dict, gt: dict, p: dict, flt) -> np.ndarray:
    """The first failing filter's code, in the order Sniffles2 applies them."""
    svtype, svlen = st["svtype"], st["svlen"]
    alen = np.abs(svlen)
    alenf = flt(alen)
    support = st["support"]
    sdp, sdl = st["stdev_pos"], st["stdev_len"]
    u, s_, c, e, d = (flt(cov[k]) for k in ("coverage_upstream", "coverage_start",
                                             "coverage_center", "coverage_end",
                                             "coverage_downstream"))
    bnd = svtype == BND
    single = (svtype == SINGLE_LEFT) | (svtype == SINGLE_RIGHT)
    safe = np.maximum(alenf, flt(1))
    mosaic = np.bool_(p["mosaic"] > 0)
    fl = flt

    def div(a, b):
        return fl(a / b)
    f_sdp = ((sdp > fl(p["qc_stdev_abs_max"])) | (~bnd & ~single & (div(sdp, safe) > 2))) \
        & (p["qc_stdev"] > 0)
    f_sdl = (sdl != 0) & ((~bnd & (div(sdl, safe) > 1)) | (sdl > fl(p["qc_stdev_abs_max"]))) \
        & (p["qc_stdev"] > 0)
    f_minlen = (alen < p["minsvlen"]) & ~bnd & ((support < 10) | (p["minsvlen_hard_cap"] > 0))
    f_strand_bnd = bnd & (p["qc_bnd_filter_strand"] > 0) & (st["n_strands"] < 2)
    eps = fl(1e-6)
    slope_dn = (u > c) & (c > d)
    slope_up = (u < c) & (c < d)
    slope = (slope_dn & (div(d, np.maximum(u, eps)) < fl(0.7))) \
        | (slope_up & (div(u, np.maximum(d, eps)) < fl(0.7)))
    ud_del = np.where(u > d, (fl(0.5) > div(d, np.maximum(u, eps))) | (c > d),
                      np.where(u < d, (fl(0.5) > div(u, np.maximum(d, eps))) | (u < c), False))
    ud_dup = np.where(u > d, (fl(0.5) > div(d, np.maximum(u, eps))) | (c < d),
                      np.where(u < d, (fl(0.5) > div(u, np.maximum(d, eps))) | (u > c), False))
    long_del = (svtype == DEL) & (alenf >= fl(p["long_del_length"])) & ~mosaic \
        & (alenf <= fl(p["dev_longer_del"]))
    f_del = long_del & (((c > fl(fl(u + d) * fl(fl(p["long_del_coverage"]) / fl(2)))) & slope)
                        | ud_del)
    long_dup = (svtype == DUP) & (alenf >= fl(p["long_dup_length"])) & ~mosaic \
        & (alenf <= fl(p["dev_longer_dup"]))
    f_dup = long_dup & (c < fl(fl(u + d) * fl(fl(p["long_dup_coverage"]) / fl(2)))) \
        & (slope | ud_dup)
    f_ins = (svtype == INS) & ((u < fl(p["qc_coverage"])) | (d < fl(p["qc_coverage"])))

    # minimum support: auto from the regional coverage blended with the global
    n_ud = (u != 0).astype(np.int64) + (d != 0).astype(np.int64)
    regional = np.where(n_ud > 0, np.round(div(fl(u + d), fl(np.maximum(n_ud, 1)))), fl(0))
    n_sce = (s_ != 0).astype(np.int64) + (c != 0).astype(np.int64) + (e != 0).astype(np.int64)
    sce = np.where(n_sce > 0, np.round(div(fl(fl(s_ + c) + e), fl(np.maximum(n_sce, 1)))),
                   fl(0))
    regional = np.where(n_ud > 0, regional, sce)
    glob = fl(p["coverage_global"])
    regional = np.where(regional == 0, glob, regional)
    w = fl(p["minsupport_auto_regional_coverage_weight"])
    blend = fl(fl(regional * w) + fl(glob * fl(fl(1) - w)))
    auto = np.round(fl(fl(p["minsupport_auto_base"]) + fl(fl(p["minsupport_auto_mult"]) * blend)))
    if p["minsupport_is_auto"] > 0:
        f_support = _rescaled(st, p, flt) < auto
    else:
        f_support = fl(support) < fl(p["minsupport_const"])
    f_support = f_support & ~mosaic

    af = gt["af"]
    is_mosaic = af <= fl(p["mosaic_af_max"])
    gt_sum = gt["gt_a"] + gt["gt_b"]
    f_cov_min_gt = (c < fl(p["qc_coverage"])) & (gt_sum < 2) & (svtype != DEL) \
        & (alenf > fl(p["long_del_length"]))
    f_nm = (p["qc_nm"] > 0) & (st["nm"] > fl(fl(p["qc_nm_threshold"]) * fl(p["qc_nm_mult"]))) \
        & (gt["gt_b"] == 0)
    skip_dup = (svtype == DUP) & (af >= fl(p["dev_min_dup_vaf"]))
    f_vaf_germline = ~mosaic & is_mosaic & ~skip_dup
    mos = mosaic & is_mosaic
    f_mos_support = mos & (support < p["mosaic_min_reads"])
    f_mos_len = mos & ~bnd & (alenf > fl(p["max_svlen_mosaic"]))
    long_ins = (svtype == INS) & (fl(svlen) >= fl(p["long_ins_length"]))
    f_strand = (p["qc_strand"] > 0) & ~mos & ~bnd & ~long_ins & (st["n_strands"] < 2)
    f_strand_mos = mos & (p["mosaic_qc_strand"] > 0) & ~bnd & ~long_ins \
        & (st["n_strands"] < 2) & (support >= p["mosaic_use_strand_thresholds"])
    f_mos_invdup = mos & ((svtype == INV) | (svtype == DUP)) \
        & (fl(svlen) < fl(p["mosaic_qc_invdup_min_length"]))
    long_inv = (svtype == INV) & (fl(svlen) > fl(p["long_inv_length"])) & ~mos
    f_cov_min = (c < fl(p["qc_coverage"])) & ~((svtype == DEL) | (svtype == INS)) & ~long_inv
    f_mos_window = mos & ((af < fl(p["mosaic_af_min"])) | (af > fl(p["mosaic_af_max"])))
    f_not_mosaic = mosaic & ~is_mosaic & (p["mosaic_include_germline"] == 0)
    f_gt = (gt["zscore"] < p["genotype_min_z_score"]) & ~mosaic \
        & ~(long_ins & (p["detect_large_ins"] > 0)) & ~skip_dup
    cascade = [(f_sdp, "STDEV_POS"), (f_sdl, "STDEV_LEN"), (single, "SINGLE_BREAK"),
               (f_minlen, "SVLEN_MIN"), (f_strand_bnd, "STRAND_BND"), (f_del, "COV_CHANGE_DEL"),
               (f_dup, "COV_CHANGE_DUP"), (f_ins, "COV_CHANGE_INS"), (f_support, "SUPPORT_MIN"),
               (gt["gt_failed"], "GT_FAILED"), (f_gt, "GT"), (f_cov_min_gt, "COV_MIN_GT"),
               (f_nm, "ALN_NM"), (f_vaf_germline, "MOSAIC_VAF"), (f_mos_support, "SUPPORT_MIN"),
               (f_mos_len, "SVLEN_MAX_MOSAIC"), (f_strand, "STRAND"),
               (f_strand_mos, "STRAND_MOSAIC"), (f_mos_invdup, "SVLEN_MIN_MOSAIC"),
               (f_cov_min, "COV_MIN"), (f_mos_window, "MOSAIC_VAF"),
               (f_not_mosaic, "NOT_MOSAIC_VAF")]
    code = np.zeros(svtype.shape[0], dtype=np.int64)
    for fail, name in reversed(cascade):
        code = np.where(fail, CODE[name], code)
    return code


def engine_step(sig: dict, coverage, params: dict, flt=f32, cluster_flt=None) -> dict:
    """{key: array [n_clusters]} of every cluster of the batch, the keys of
    INT_KEYS, FLOAT_KEYS and BOOL_KEYS. `cluster_flt`, where given, rounds
    the clustering's arithmetic in place of `flt`."""
    st = statistics(cluster(sig, params, cluster_flt or flt), flt)
    cov = coverage_probes(coverage, st)
    gt = genotype(st, cov, params, flt)
    code = qc(st, cov, gt, params, flt)
    is_sv = (st["svtype"] >= INS) & (st["svtype"] <= INV)
    out = {k: v for k, v in st.items() if k != "support_sa"}
    out.update(cov)
    out.update(gt)
    out["filter_code"] = code
    out["qc"] = code == 0
    out["precise"] = flt(st["stdev_pos"] + st["stdev_len"]) < 25
    out["cluster_valid"] = (~is_sv | (np.abs(st["svlen"]) >= params["minsvlen_screen"])) \
        & (st["lead_count"] > 0)
    return out


def compare(got: dict, want: dict) -> dict:
    """{"rows_differ": the rows (clusters) whose integer or boolean keys
    differ in any, or every row where the cluster counts differ;
    "float_gap": the widest gap of a float key, |got - want| over
    max(|want|, 1), or 1 where the cluster counts differ}."""
    n_got, n_want = got["svtype"].shape[0], want["svtype"].shape[0]
    if n_got != n_want:
        return {"rows_differ": max(n_got, n_want), "float_gap": 1.0}
    bad = np.zeros(n_want, dtype=bool)
    for k in INT_KEYS + BOOL_KEYS:
        bad |= np.asarray(got[k]).astype(np.int64) != np.asarray(want[k]).astype(np.int64)
    gap = 0.0
    for k in FLOAT_KEYS:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        if n_want:
            gap = max(gap, float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1.0))))
    return {"rows_differ": int(bad.sum()), "float_gap": gap}
