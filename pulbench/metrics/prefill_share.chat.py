"""prefill_share.chat: the share of the window spent in the engine's
``engine/prefill@<bucket>`` spans, in %."""


def read(run):
    spans = [e - s for name, s, e in run.spans
             if name.startswith("engine/prefill@")]
    return 100.0 * sum(spans) / run.window_s if spans else None
