"""Host ms a step of the loss (``dssim_mse_loss``) and of the optimizer
(AdamW's and the schedule's step, ``project_unit``), each span closed by a
device sync, over steps run after the profiled ones."""


def read(trace):
    s = trace.spans
    if not trace.span_units or "loss" not in s or "optim" not in s:
        return None
    return (s["loss"] + s["optim"]) / trace.span_units * 1e3
