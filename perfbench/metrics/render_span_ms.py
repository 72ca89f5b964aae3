"""render_span_ms.<kind>: device ms a call or step inside the program's `render` spans
(deepim_tpu_torch/utils/tracing.py), the mean over the first traced calls, those of the device-only pass;
nothing where the program has no spans or the run no device intervals."""


def read(ctx):
    r = ctx.get("trace")
    if r is None:
        return None
    try:
        from deepim_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.layer_ms(tracing.calls()[: r["calls"]], ("render",), "device")
