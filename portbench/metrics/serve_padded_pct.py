"""Padding rows' share of the dispatched batch slots (ServerStats
padded_images over images + padded_images), in %."""


def read(run, out, rest):
    server = out.counters.get("server")
    if not server or not server["batches"]:
        return None
    slots = server["images"] + server["padded_images"]
    return 100.0 * server["padded_images"] / slots
