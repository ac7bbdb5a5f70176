"""mfu.serve: the model FLOPs of the window's decode steps and prefills
(``arith``: live slots and real prompt tokens only) over the window's
seconds times the card's bf16 peak, in %."""
from pulbench import arith


def read(run):
    if run.peaks is None or not run.ticks:
        return None
    flops = sum(arith.decode_flops(run.arch, t.decode)
                + sum(arith.prefill_flops(run.arch, p) for p in t.prefill)
                for t in run.ticks)
    return 100.0 * flops / (run.window_s * run.peaks["bf16_flops"])
