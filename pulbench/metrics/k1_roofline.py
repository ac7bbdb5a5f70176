"""k1_roofline: K1 (``csrc/pul_paged_decode.cu``, its split and merge
kernels) over the traced slice: the bytes it must move (each live slot's
cached K/V rows of a layer once, its query read, its output written, its
new row read and committed; ``arith.attention_kernel_bytes``) over its
device time times the HBM rate, in %. Nothing to read for an MLA model (K3
runs there)."""
from pulbench import arith
from pulbench.trace import PAGED_DECODE


def read(run):
    if (run.arch.family != "dense_gqa" or run.device_trace is None
            or run.peaks is None):
        return None
    seconds, launches = run.device_trace.seconds_of(PAGED_DECODE)
    if not launches:
        return None
    nbytes = sum(run.arch.layers
                 * arith.attention_kernel_bytes(run.arch, t.decode)
                 for t in run.profiled_ticks)
    return 100.0 * nbytes / (seconds * run.peaks["hbm_bytes_per_s"])
