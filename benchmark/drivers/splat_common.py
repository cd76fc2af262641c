"""What the splatting drivers share: the program's view of a scene made by
``harness.scene`` and the reference's counting of live pairs."""

from __future__ import annotations

import torch

from benchmark.reference import splat


def program_mesh(mesh: dict):
    """The scene's mesh as the program's ``Mesh`` (unit normals of the
    rest plane)."""
    from cloth_splatting_tpu_torch.models.gaussians import Mesh

    normals = torch.zeros_like(mesh["rest"])
    normals[:, 2] = 1.0
    return Mesh(pos=mesh["rest"], faces=mesh["faces"], edge_index=mesh["edges"],
                edge_norm=mesh["edge_len"], normals=normals)


def program_field(field: dict, face_ids: torch.Tensor, alive: torch.Tensor):
    """(GaussianParams, GaussianState) of a field, as copies."""
    from cloth_splatting_tpu_torch.models.gaussians import GaussianParams, GaussianState

    cap = alive.shape[0]
    dev = alive.device
    params = GaussianParams(**{k: field[k].clone() for k in splat.FIELD_KEYS})
    state = GaussianState(face_ids=face_ids.clone(), alive=alive.clone(),
                          max_radii2d=torch.zeros(cap, device=dev),
                          grad_accum=torch.zeros(cap, device=dev),
                          denom=torch.zeros(cap, device=dev))
    return params, state


def camera_arrays(cam: dict):
    from cloth_splatting_tpu_torch.render import CameraArrays

    return CameraArrays(world_view=cam["world_view"], full_proj=cam["full_proj"],
                        camera_center=cam["center"], time=cam["time"])


def count_item(field: dict, alive, ref_scene: dict, verts, cam: dict,
               sh_degree: int) -> dict:
    """The compositor's work on one camera as the counts take it: live
    pairs before T_EXIT, valid Gaussians, pixels."""
    with torch.no_grad():
        proj = splat.project_view(field, alive, ref_scene, verts, cam, sh_degree)
        _, _, _, pairs = splat.composite(proj, ref_scene["width"], ref_scene["height"],
                                         ref_scene["bg"])
    return {"pairs": int(pairs), "gaussians": int(proj["valid"].sum()),
            "pixels": ref_scene["width"] * ref_scene["height"]}
