"""emit_ms_p50: the median ``engine/decode_emit`` span of the window, in
ms: the decode tick's tokens (each live slot's host argmax over its logits
row, its length, a finished request's pages released)."""
import statistics


def read(run):
    spans = [e - s for name, s, e in run.spans
             if name == "engine/decode_emit"]
    return statistics.median(spans) * 1e3 if spans else None
