"""kernels_roofline.backlog: the program's counted kernels in the traced
stretch, the sum of their launches' bounds over the sum of their device
time, in %.  Kernels that are not counted are listed, with their share,
in the result line's "kernels" entry."""


def read(run):
    if run.window.loop != "closed":
        return None
    return run.roofline
