"""driver_host_ms.<kind>: host ms a call or step inside its outermost span (`refine.call`, `train.step`) but outside
the `render`, `zoom` and `net.*` spans: the loop, `pose.update`, `loss`, `optim.step`
(deepim_tpu_torch/utils/tracing.py), the mean over the first traced calls, those of the device-only pass;
nothing where the program has no spans."""


def read(ctx):
    r = ctx.get("trace")
    if r is None:
        return None
    try:
        from deepim_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.layer_ms(tracing.calls()[: r["calls"]], ("render", "zoom", "net.forward", "net.backward"), "host",
                            outside=True)
