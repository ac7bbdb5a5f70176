"""step_roofline.decode: over the window's ticks with no prefill, the
least time the card could take for each decode step (the larger of its
FLOPs over the bf16 peak and its bytes over the HBM rate, ``arith``) summed,
over the sum of their ``engine/tick`` spans, in %."""
from pulbench import arith


def read(run):
    if run.peaks is None:
        return None
    bound = spent = 0.0
    for t in run.ticks:
        if t.prefill or not t.decode or t.span_s is None:
            continue
        bound += max(arith.decode_flops(run.arch, t.decode)
                     / run.peaks["bf16_flops"],
                     arith.decode_bytes(run.arch, t.decode)
                     / run.peaks["hbm_bytes_per_s"])
        spent += t.span_s
    return 100.0 * bound / spent if spent else None
