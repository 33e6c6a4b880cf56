"""Program counters that more than one metric reads."""


def cgrid():
    """The C-grid stage cache's lanes checked and misses, as integers."""
    from parcels_tpu_torch.ops import stagecache

    c = stagecache.cgrid_cached_eval
    return {"cgrid_checked": int(c.checked_lanes), "cgrid_misses": int(c.misses)}
