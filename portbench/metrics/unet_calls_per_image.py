"""UNet forwards per image over the window: a forward pre-hook on the
pipeline's UNet, over the images the window returned."""


def read(run, out, rest):
    calls, images = out.counters.get("unet_calls"), out.counters.get("images")
    if not calls or not images:
        return None
    return calls / images
