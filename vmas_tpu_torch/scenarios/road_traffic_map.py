"""CPM-lab map loading and reference-path construction for road_traffic.

Counterpart of vmas_tpu/scenarios/road_traffic_map.py, in numpy only: the
port keeps its own copy of this module and of the map XML
(``vmas_tpu_torch/scenarios_data/road_traffic/road_traffic_cpm_lab.xml``,
byte-identical to the JAX package's). The XML lanelets are stitched into
reference paths and packed into dense padded arrays (paths x max_points x
2) that the scenario gathers from by path id.

The lanelet-loop / path / shared-boundary tables are map metadata (data,
not logic), kept verbatim so trajectories are comparable.
"""

from __future__ import annotations

import pathlib
import xml.etree.ElementTree as ET
from types import SimpleNamespace

import numpy as np

DEFAULT_MAP_PATH = str(
    pathlib.Path(__file__).parent.parent
    / "scenarios_data"
    / "road_traffic"
    / "road_traffic_cpm_lab.xml"
)

# Lanelet loops
REFERENCE_LANELETS_LOOPS = [
    [4, 6, 8, 60, 58, 56, 54, 80, 82, 84, 86, 34, 32, 30, 28, 2],
    [1, 3, 23, 10, 12, 17, 43, 38, 36, 49, 29, 27],
    [64, 62, 75, 55, 53, 79, 81, 101, 88, 90, 95, 69],
    [40, 45, 97, 92, 94, 100, 83, 85, 33, 31, 48, 42],
    [5, 7, 59, 57, 74, 68, 66, 71, 19, 14, 16, 22],
    [41, 39, 20, 63, 61, 57, 55, 67, 65, 98, 37, 35, 31, 29],
    [3, 5, 9, 11, 72, 91, 93, 81, 83, 87, 89, 46, 13, 15],
]

# path id -> (loop index, starting lanelet)
PATH_TO_LOOP = {
    1: (1, 4), 2: (2, 1), 3: (3, 64), 4: (4, 42), 5: (5, 22), 6: (6, 39),
    7: (7, 15), 8: (1, 8), 9: (2, 10), 10: (3, 75), 11: (4, 45), 12: (5, 59),
    13: (6, 61), 14: (7, 5), 15: (1, 58), 16: (2, 17), 17: (3, 79), 18: (4, 92),
    19: (5, 68), 20: (6, 55), 21: (7, 11), 22: (1, 54), 23: (2, 38), 24: (3, 88),
    25: (4, 100), 26: (5, 19), 27: (6, 65), 28: (7, 93), 29: (1, 82), 30: (2, 49),
    31: (3, 95), 32: (4, 33), 33: (5, 14), 34: (6, 35), 35: (7, 83), 36: (1, 86),
    37: (6, 29), 38: (7, 89), 39: (1, 32), 40: (1, 28),
}

PATH_INTERSECTION = [
    [11, 25, 13], [11, 26, 52, 37], [11, 72, 91], [12, 18, 14],
    [12, 17, 43, 38], [12, 73, 92], [39, 51, 37], [39, 50, 102, 91],
    [39, 20, 63], [40, 44, 38], [40, 45, 97, 92], [40, 21, 64],
    [89, 103, 91], [89, 104, 78, 63], [89, 46, 13], [90, 96, 92],
    [90, 95, 69, 64], [90, 47, 14], [65, 77, 63], [65, 76, 24, 13],
    [65, 98, 37], [66, 70, 64], [66, 71, 19, 14], [66, 99, 38],
]
PATH_MERGE_IN = [[34, 32], [33, 31], [35, 31], [36, 49]]
PATH_MERGE_OUT = [[6, 8], [5, 7], [5, 9], [23, 10]]

LANELETS_SHARE_SAME_BOUNDARIES = [
    [4, 3, 22], [6, 5, 23], [8, 7], [60, 59], [58, 57, 75], [56, 55, 74],
    [54, 53], [80, 79], [82, 81, 100], [84, 83, 101], [86, 85], [34, 33],
    [32, 31, 49], [30, 29, 48], [28, 27], [2, 1],
    [13, 14], [15, 16], [9, 10], [11, 12],
    [63, 64], [61, 62], [67, 68], [65, 66],
    [91, 92], [93, 94], [87, 88], [89, 90],
    [37, 38], [35, 36], [41, 42], [39, 40],
    [25, 18], [26, 17], [52, 43], [72, 73],
    [51, 44], [50, 45], [102, 97], [20, 21],
    [103, 96], [104, 95], [78, 69], [46, 47],
    [77, 70], [76, 71], [24, 19], [98, 99],
]


def _parse_point(el):
    return np.array([float(el.find("x").text), float(el.find("y").text)], np.float32)


def _parse_bound(el):
    return np.stack([_parse_point(p) for p in el.findall("point")])


def parse_map(map_file_path: str = None):
    """Parse the CPM lab map XML into its lanelets and mean lane width."""
    if map_file_path is None:
        map_file_path = DEFAULT_MAP_PATH
    root = ET.parse(map_file_path).getroot()
    lanelets = {}
    for child in root:
        if child.tag == "lanelet":
            lid = int(child.get("id"))
            left = _parse_bound(child.find("leftBound"))
            right = _parse_bound(child.find("rightBound"))
            lanelets[lid] = {"left": left, "right": right, "center": (left + right) / 2}
    widths = np.concatenate(
        [np.linalg.norm(l["left"] - l["right"], axis=1) for l in lanelets.values()]
    )
    return {"lanelets": lanelets, "mean_lane_width": float(widths.mean())}


def _loop_for_path(path_id: int):
    """The lanelet loop of a path, rotated to start at its first lanelet."""
    loop_index, starting_lanelet = PATH_TO_LOOP[path_id]
    loop = REFERENCE_LANELETS_LOOPS[loop_index - 1]
    k = loop.index(starting_lanelet)
    return loop[k:] + loop[:k]


def _calculate_reference_path(lanelet_ids, map_data):
    """Stitch consecutive lanelets into one reference path."""
    lanelets = map_data["lanelets"]
    left = right = left_sh = right_sh = None
    for lid in lanelet_ids:
        group = next(g for g in LANELETS_SHARE_SAME_BOUNDARIES if lid in g)
        lb = lanelets[lid]["left"]
        rb = lanelets[lid]["right"]
        lbs = lanelets[group[0]]["left"]
        rbs = lanelets[group[-1]]["right"]
        if left is None:
            left, right, left_sh, right_sh = lb, rb, lbs, rbs
        else:
            if np.linalg.norm(left[-1] - lb[0]) < 1e-4:
                left = np.concatenate([left, lb[1:]])
                left_sh = np.concatenate([left_sh, lbs[1:]])
            else:
                left = np.concatenate([left, lb])
                left_sh = np.concatenate([left_sh, lbs])
            if np.linalg.norm(right[-1] - rb[0]) < 1e-4:
                right = np.concatenate([right, rb[1:]])
                right_sh = np.concatenate([right_sh, rbs[1:]])
            else:
                right = np.concatenate([right, rb])
                right_sh = np.concatenate([right_sh, rbs])

    center = (left + right) / 2
    is_loop = np.linalg.norm(center[0] - center[-1]) <= 1e-4
    vec = np.diff(center, axis=0)
    vec_len = np.linalg.norm(vec, axis=1)
    vec_norm = vec / vec_len[:, None]
    yaw = np.arctan2(vec[:, 1], vec[:, 0])
    return {
        "center_line": center.astype(np.float32),
        "center_line_yaw": yaw.astype(np.float32),
        "center_line_vec_normalized": vec_norm.astype(np.float32),
        "left_boundary_shared": left_sh.astype(np.float32),
        "right_boundary_shared": right_sh.astype(np.float32),
        "is_loop": bool(is_loop),
    }


def build_reference_paths(map_data):
    """(all loop paths, intersection, merge-in, merge-out) path lists."""
    all_paths = [
        _calculate_reference_path(_loop_for_path(pid + 1), map_data)
        for pid in range(len(PATH_TO_LOOP))
    ]
    inter = [_calculate_reference_path(ids, map_data) for ids in PATH_INTERSECTION]
    merge_in = [_calculate_reference_path(ids, map_data) for ids in PATH_MERGE_IN]
    merge_out = [_calculate_reference_path(ids, map_data) for ids in PATH_MERGE_OUT]
    return all_paths, inter, merge_in, merge_out


def pad_paths(paths, n_extend: int, max_points: int = None):
    """Pack a list of reference paths into dense padded arrays.

    Each path's center line is extended by ``n_extend`` points along its last
    segment direction, then padded with its final point; boundaries are
    padded with their final point, so the padding segments have zero length.
    """
    if max_points is None:
        max_points = max(p["center_line"].shape[0] for p in paths) + n_extend + 2
    P = len(paths)
    max_b = max(
        max(p["left_boundary_shared"].shape[0], p["right_boundary_shared"].shape[0])
        for p in paths
    )
    out = SimpleNamespace(
        center=np.zeros((P, max_points, 2), np.float32),
        vec_norm=np.zeros((P, max_points, 2), np.float32),
        yaw=np.zeros((P, max_points), np.float32),
        left_b=np.zeros((P, max_b, 2), np.float32),
        right_b=np.zeros((P, max_b, 2), np.float32),
        n_points=np.zeros(P, np.int32),
        n_left=np.zeros(P, np.int32),
        n_right=np.zeros(P, np.int32),
        is_loop=np.zeros(P, bool),
        entry=np.zeros((P, 2, 2), np.float32),
        exit=np.zeros((P, 2, 2), np.float32),
        max_points=max_points,
        max_b=max_b,
    )
    for i, p in enumerate(paths):
        c = p["center_line"]
        n = c.shape[0]
        direction = c[-1] - c[-2]
        ext = c[-1] + np.arange(1, n_extend + 1, dtype=np.float32)[:, None] * direction
        full = np.concatenate([c, ext])[:max_points]
        out.center[i, : full.shape[0]] = full
        out.center[i, full.shape[0]:] = full[-1]
        out.n_points[i] = n

        vn = p["center_line_vec_normalized"]
        out.vec_norm[i, : vn.shape[0]] = vn
        out.vec_norm[i, vn.shape[0]:] = vn[-1]

        yaw = p["center_line_yaw"]
        out.yaw[i, : yaw.shape[0]] = yaw
        out.yaw[i, yaw.shape[0]:] = yaw[-1]

        lb, rb = p["left_boundary_shared"], p["right_boundary_shared"]
        out.left_b[i, : lb.shape[0]] = lb
        out.left_b[i, lb.shape[0]:] = lb[-1]
        out.n_left[i] = lb.shape[0]
        out.right_b[i, : rb.shape[0]] = rb
        out.right_b[i, rb.shape[0]:] = rb[-1]
        out.n_right[i] = rb.shape[0]
        out.is_loop[i] = p["is_loop"]
        out.entry[i] = np.stack([lb[0], rb[0]])
        out.exit[i] = np.stack([lb[-1], rb[-1]])
    return out
