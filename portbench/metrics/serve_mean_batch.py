"""Real images per served dispatch over the window (ServerStats images /
batches), held against the benchmark's own record of each variant call."""


def read(run, out, rest):
    server, calls = out.counters.get("server"), out.counters.get("dispatches")
    if not server or not server["batches"]:
        return None
    if (server["batches"], server["images"]) != (len(calls), sum(r for _, r in calls)):
        raise RuntimeError(f"ServerStats {server} disagrees with the variant calls "
                           f"({len(calls)} calls, {sum(r for _, r in calls)} images)")
    return server["images"] / server["batches"]
