"""K2's (``packed_hop``) summed device time over the traced requests, a
request."""

#: the device function of K2 (csrc/packed_hop.cu)
K2_KERNELS = {"packed_hop_kernel"}


def read(run):
    tr = run.trace
    if tr is None or not tr.requests:
        return None
    busy = tr.kernel_s(K2_KERNELS)
    if busy <= 0:
        return None
    return busy * 1e3 / tr.requests
