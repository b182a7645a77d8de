"""SAPIEN URDF parsing + per-part model normalization info (counterpart of
`captra_tpu/data/urdf.py`).

Produces the `model_info` dict consumed by `captra_tpu_torch.data.sapien`:
    {num_parts, tree, corner, factor, obj2link, global_corner, global_factor}

Mesh vertices are read with a minimal OBJ parser (`v x y z` lines) — no
trimesh dependency; norm factor = 1 / bbox diagonal per part.  Line
references (data_utils.py:N) are to the reference's datasets/data_utils.py.
"""
from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from os.path import join as pjoin

import numpy as np


def parse_urdf(urdf_path: str) -> dict:
    """Mobility URDF -> link origins/meshes + joint table (reference
    get_urdf_mobility, data_utils.py:261-390).  Link index 0 is the base;
    link_k maps to index k+1."""
    if not urdf_path.endswith(".urdf"):
        urdf_path = pjoin(urdf_path, "mobility.urdf")
    base_dir = os.path.dirname(urdf_path)
    root = ET.parse(urdf_path).getroot()

    links = root.findall("link")
    n_links = len(links)

    def link_index(name: str) -> int:
        return 0 if name == "base" else int(name.split("_")[1]) + 1

    link_xyz = [[] for _ in range(n_links)]
    link_rpy = [[] for _ in range(n_links)]
    link_obj = [[] for _ in range(n_links)]
    for link in links:
        i = link_index(link.attrib["name"])
        for visual in link.iter("visual"):
            for origin in visual.iter("origin"):
                link_xyz[i].append(
                    [float(x) for x in origin.attrib.get(
                        "xyz", "0 0 0").split()])
                link_rpy[i].append(
                    [float(x) for x in origin.attrib.get(
                        "rpy", "0 0 0").split()])
            for mesh in visual.iter("mesh"):
                fname = mesh.attrib["filename"]
                if not os.path.isabs(fname):
                    fname = pjoin(base_dir, fname)
                link_obj[i].append(fname)

    n_joints = n_links - 1
    joints = {k: [None] * n_joints for k in
              ("type", "parent", "child", "xyz", "rpy", "axis")}
    joints["limit"] = [[0.0, 0.0]] * n_joints
    for joint in root.iter("joint"):
        child = joint.find("child")
        j = link_index(child.attrib["link"]) - 1
        joints["child"][j] = link_index(child.attrib["link"])
        joints["type"][j] = joint.attrib["type"]
        parent = joint.find("parent")
        joints["parent"][j] = link_index(parent.attrib["link"])
        origin = joint.find("origin")
        if origin is not None:
            joints["xyz"][j] = [float(x) for x in
                                origin.attrib.get("xyz", "0 0 0").split()]
            joints["rpy"][j] = [float(x) for x in
                                origin.attrib.get("rpy", "0 0 0").split()]
        axis = joint.find("axis")
        if axis is not None:
            joints["axis"][j] = [float(x) for x in
                                 axis.attrib["xyz"].split()]
        limit = joint.find("limit")
        if limit is not None:
            joints["limit"][j] = [float(limit.attrib.get("lower", 0)),
                                  float(limit.attrib.get("upper", 0))]

    return {"num_links": n_links,
            "link": {"xyz": link_xyz, "rpy": link_rpy},
            "obj_name": link_obj,
            "joint": joints}


def read_obj_vertices(path: str) -> np.ndarray:
    """Minimal OBJ vertex reader ('v x y z' lines)."""
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
    return np.asarray(verts, np.float64)


def _euler_matrix(r, p, y) -> np.ndarray:
    """Intrinsic sxyz euler -> rotation (the two reference call sites use
    the transformations.py default 'sxyz' convention)."""
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def obj2link_dict(urdf: dict) -> dict:
    """Per-part mesh->link transforms from the link visual origins
    (reference get_obj2link_dict, data_utils.py:182-203)."""
    num_parts = urdf["num_links"] - 1
    out = {}
    for k in range(num_parts):
        xyz = np.asarray(urdf["link"]["xyz"][k + 1]).reshape(-1)
        rpy = np.asarray(urdf["link"]["rpy"][k + 1]).reshape(-1)
        mat = np.eye(4)
        mat[:3, :3] = _euler_matrix(*rpy[:3])
        mat[:3, 3] = xyz[:3]
        out[k] = mat
    return out


def model_corners_factors(obj_file_list):
    """Per-part (and global) bbox corners + 1/diagonal norm factors from the
    part meshes (reference get_all_objs, data_utils.py:393-453)."""
    part_pts = []
    for objs in obj_file_list:
        if not objs:
            continue
        pts = np.concatenate([read_obj_vertices(o) for o in objs], axis=0)
        part_pts.append(pts)

    def stats(pts):
        pmin, pmax = pts.min(0), pts.max(0)
        factor = 1.0 / math.sqrt(float(np.sum((pmax - pmin) ** 2)))
        return [pmin, pmax], factor

    all_pts = np.concatenate(part_pts, axis=0)
    corners = [stats(all_pts)[0]] + [stats(p)[0] for p in part_pts]
    factors = [stats(all_pts)[1]] + [stats(p)[1] for p in part_pts]
    return corners, factors


def generate_instance_info(root_dset: str, obj_category: str,
                           instance: str) -> dict:
    """URDF + meshes -> model_info (reference generate_instance_info,
    arti_data_process.py:129-148)."""
    urdf = parse_urdf(pjoin(root_dset, "urdf", obj_category, instance))
    obj_files = urdf["obj_name"]
    if obj_files and obj_files[0] == []:
        obj_files = obj_files[1:]
    corners, factors = model_corners_factors(obj_files)
    parents = [p - 1 for p in urdf["joint"]["parent"]]
    return {"num_parts": urdf["num_links"] - 1,
            "global_corner": corners[0],
            "global_factor": factors[0],
            "corner": corners[1:],
            "factor": factors[1:],
            "obj2link": obj2link_dict(urdf),
            "tree": parents}
