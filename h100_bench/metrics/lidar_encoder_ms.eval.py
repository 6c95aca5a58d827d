"""Device milliseconds a batch in the LiDAR levels (every cascade stage's
lidar_lv1-4 forward: FPS and KNN or the range-grid selects, grouping, the
levels' MLPs)."""

RANGES = {"lidar_encoder": {"modules": ["lidar_lv1", "lidar_lv2", "lidar_lv3", "lidar_lv4"],
                            "backward": False}}


def read(r):
    if r.loop != "eval" or "lidar_encoder" not in r.range_s:
        return None
    return 1e3 * r.range_s["lidar_encoder"] / r.units
