"""UNet rows computed per image delivered: the rows of the program's
pipeline.unet spans over the images, counting only the served dispatches
(serve.dispatch, images its real requests, so padding rows count as
waste) or, where nothing is served, the sample calls (pipeline.sample,
images its batch) that lie wholly inside the traced window. A guided
20-step call reads 40."""
from portbench import program_spans


def read(run, out, rest):
    win = program_spans.window(out)
    if win is None:
        return None
    root, images = "serve.dispatch", "real"
    if not win.named(root):
        root, images = "pipeline.sample", "batch"
    whole = {s.id: s for s in win.whole(root)}
    if not whole:
        return None
    rows = sum(s.attrs["rows"] for s in win.named("pipeline.unet")
               if getattr(win.ancestor(s, (root,)), "id", None) in whole)
    return rows / sum(s.attrs[images] for s in whole.values())
