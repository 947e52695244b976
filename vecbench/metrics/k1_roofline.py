"""K1's share of its roofline: the least time the exact scan of one request
could take on the card (``peaks.exact_scan_work`` at the request's shapes,
against 3xTF32's f32-accurate peak and the memory rate), over K1's device
time a launch in the traced stretch (its kernels by name from the
profiler; launches from ``fused_topk.launches``)."""

from vecbench import peaks

#: the device functions of K1 (csrc/fused_topk.cu, csrc/topk_fold.cuh)
K1_KERNELS = {"split_queries", "topk_pass1", "topk_merge"}


def read(run):
    tr = run.trace
    if tr is None:
        return None
    launches = tr.counters.get("fused_topk", 0)
    busy = tr.kernel_s(K1_KERNELS)
    if launches <= 0 or busy <= 0:
        return None
    cfg, wl = run.cell.config, run.cell.workload
    flops, nbytes = peaks.exact_scan_work(wl["request_queries"], cfg["rows"],
                                          cfg["dim"], wl["k"])
    least, _ = peaks.bound_s(nbytes, flops)
    return 100.0 * least / (busy / launches)
