"""setup.capture_s: the captured steps' own seconds, the sum of each
FusedStep's warmup_s + capture_s + instantiate_s."""


def read(run):
    return run.spans.get("capture")
