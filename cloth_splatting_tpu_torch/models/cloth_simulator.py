"""Action-conditioned cloth dynamics, the paper's GNN model; counterpart of
``cloth_splatting_tpu/models/cloth_simulator.py``.

  * node features = velocity history [V, 3 * hist] (the grasped node's last
    three components overwritten by the action-induced velocity) ++ one-hot
    node type (cloth 0, grasped 1);
  * edge features = [pos_dst - pos_src (3), its norm (1)];
  * the GNN predicts each node's ACCELERATION; the target is target_vel -
    vel[:, -3:] (of the noised velocity in training);
  * optional accumulating normalizers on node features and outputs;
  * a rollout integrates vel += acc, pos += vel, with the grasped node's
    velocity set to the action each step.

The state is a dict {"gnn": parameter tree, "node_norm", "out_norm"}
(``models/meshnet.py``), the JAX package's layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cloth_splatting_tpu_torch.models.meshnet import (
    apply_encode_process_decode,
    init_encode_process_decode,
    init_normalizer,
    normalizer_apply,
    normalizer_inverse,
)
from cloth_splatting_tpu_torch.utils.profiling import span

NODE_TYPES = 2  # cloth, grasped


def init_cloth_simulator(rng: np.random.Generator, input_sequence_length: int = 2,
                         n_message_passing: int = 15, latent: int = 128,
                         normalize: bool = True,
                         device: str | torch.device = "cuda") -> dict:
    """{gnn, node_norm, out_norm}; ``normalize`` is the caller's flag (kept
    for the JAX package's signature)."""
    nnode_in = NODE_TYPES + 3 * input_sequence_length
    return {
        "gnn": init_encode_process_decode(
            rng, nnode_in=nnode_in, nnode_out=3, nedge_in=4, latent=latent,
            n_message_passing=n_message_passing, n_mlp_layers=2,
            mlp_hidden=latent, device=device),
        "node_norm": init_normalizer(nnode_in, device),
        "out_norm": init_normalizer(3, device),
    }


def edge_features_from_positions(pos: torch.Tensor, edge_index: torch.Tensor):
    """[E, 4] = [pos_dst - pos_src, its norm]."""
    disp = pos.index_select(0, edge_index[1]) - pos.index_select(0, edge_index[0])
    norm = torch.linalg.vector_norm(disp, dim=-1, keepdim=True)
    return torch.cat([disp, norm], -1)


def node_type_onehot(node_type: torch.Tensor) -> torch.Tensor:
    return F.one_hot(node_type.long(), NODE_TYPES).to(torch.float32)


def predict_acceleration(
    state: dict,
    velocity: torch.Tensor,          # [V, 3*hist]
    node_type: torch.Tensor,         # [V] int
    edge_index: torch.Tensor,        # [2, E]
    edge_features: torch.Tensor,     # [E, 4]
    target_velocity: torch.Tensor | None = None,   # [V, 3]
    velocity_noise: torch.Tensor | None = None,
    edge_mask: torch.Tensor | None = None,
    normalize: bool = True,
    training: bool = False,
):
    """(normalized predicted acceleration, normalized target acceleration or
    None, the state with the normalizers of this call)."""
    vel = velocity if velocity_noise is None else velocity + velocity_noise
    feats = torch.cat([vel, node_type_onehot(node_type)], -1)

    node_norm = state["node_norm"]
    if normalize:
        feats, node_norm = normalizer_apply(node_norm, feats, accumulate=training)

    pred = apply_encode_process_decode(state["gnn"], feats, edge_index,
                                       edge_features, edge_mask)

    out_norm = state["out_norm"]
    target_norm = None
    if target_velocity is not None:
        target_acc = target_velocity - vel[:, -3:]
        if normalize:
            target_norm, out_norm = normalizer_apply(out_norm, target_acc,
                                                     accumulate=training)
        else:
            target_norm = target_acc

    return pred, target_norm, {**state, "node_norm": node_norm, "out_norm": out_norm}


def predict_velocity(state: dict, velocity, node_type, edge_index, edge_features,
                     edge_mask=None, normalize: bool = True):
    """Rollout-mode prediction: the next absolute velocity [V, 3]."""
    pred, _, _ = predict_acceleration(state, velocity, node_type, edge_index,
                                      edge_features, edge_mask=edge_mask,
                                      normalize=normalize, training=False)
    acc = normalizer_inverse(state["out_norm"], pred) if normalize else pred
    return velocity[:, -3:] + acc


def update_prediction(velocity, pred_acc_unnorm, position, edge_index,
                      old_particle_actions, particle_actions):
    """Advance the unrolled training state one step.

    Args:
        velocity: [V, 3*hist] current (noised) history.
        pred_acc_unnorm: [V, 3] unnormalized predicted acceleration.
        position: [V, 3].
        old_particle_actions / particle_actions: [V, 3] the grasped node's
            action displacement at the current / next step (zero elsewhere).
    Returns (velocity, edge_features, position).
    """
    new_vel = velocity[:, -3:] + pred_acc_unnorm
    # the grasped node's velocity is known: the commanded action
    new_vel = torch.where(old_particle_actions != 0, old_particle_actions, new_vel)

    # free nodes integrate; grasped nodes move by the (next) action
    new_pos = torch.where(particle_actions == 0, position + new_vel, position)
    new_pos = new_pos + particle_actions

    edge_features = edge_features_from_positions(new_pos, edge_index)

    # shift the history, append the known or commanded velocity
    appended = torch.where(particle_actions != 0, particle_actions, velocity[:, -3:])
    velocity = torch.cat([velocity[:, 3:], appended], -1)
    return velocity, edge_features, new_pos


def edge_length_refine(velocity: torch.Tensor, positions: torch.Tensor,
                       edge_index: torch.Tensor, rest_lengths: torch.Tensor,
                       grasped: int, n_steps: int = 10, lr: float = 1e-3,
                       edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Edge-length-preserving inner optimization of real-world rollouts:
    ``n_steps`` Adam steps (b1 0.9, b2 0.999, eps 1e-8) on the predicted
    velocities minimizing sum((|edge after| - rest)^2) over the edges not
    incident to the grasped particle."""
    free = ~((edge_index[0] == grasped) | (edge_index[1] == grasped))
    if edge_mask is not None:
        free = free & edge_mask
    zero = torch.zeros((), dtype=velocity.dtype, device=velocity.device)

    def grad(vel):
        with torch.enable_grad():
            vel = vel.detach().requires_grad_()
            p = positions + vel
            d = p.index_select(0, edge_index[0]) - p.index_select(0, edge_index[1])
            lengths = torch.sqrt((d * d).sum(-1) + 1e-20)
            dev = torch.where(free, lengths - rest_lengths, zero)
            return torch.autograd.grad((dev ** 2).sum(), vel)[0]

    vel = velocity
    m = torch.zeros_like(velocity)
    v = torch.zeros_like(velocity)
    b1 = torch.tensor(0.9, dtype=torch.float32)
    b2 = torch.tensor(0.999, dtype=torch.float32)
    for i in range(n_steps):
        g = grad(vel)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        t = float(i + 1)
        mhat = m / float(1.0 - b1 ** t)
        vhat = v / float(1.0 - b2 ** t)
        vel = vel - lr * mhat / (torch.sqrt(vhat) + 1e-8)
    return vel


def rollout(
    state: dict,
    positions0: torch.Tensor,        # [V, 3]
    init_velocity: torch.Tensor,     # [hist, V, 3]
    node_type: torch.Tensor,         # [V]
    edge_index: torch.Tensor,        # [2, E]
    actions: torch.Tensor,           # [S, 3] the grasped node's action a step
    grasped: int,
    n_steps: int,
    edge_mask: torch.Tensor | None = None,
    normalize: bool = True,
    real_world: bool = False,
    rest_lengths: torch.Tensor | None = None,
    refine_steps: int = 10,
    refine_lr: float = 1e-3,
):
    """Autoregressive rollout. With ``real_world`` each predicted velocity
    is refined by ``edge_length_refine`` before integration;
    ``rest_lengths`` defaults to the t = 0 edge lengths.

    Returns (positions [S+1, V, 3], velocities [S, V, 3])."""
    grasped = int(grasped)
    hist = init_velocity.shape[0]
    vel_hist = torch.cat([init_velocity[i] for i in range(hist)], -1)  # [V, 3h]
    if real_world and rest_lengths is None:
        d0 = positions0[edge_index[0]] - positions0[edge_index[1]]
        rest_lengths = torch.sqrt((d0 * d0).sum(-1) + 1e-20)
    onehot = F.one_hot(torch.tensor(grasped, device=positions0.device),
                       positions0.shape[0]).to(positions0.dtype)[:, None]

    pos = positions0
    traj, vels = [positions0], []
    with torch.no_grad():
        for action in actions[:n_steps]:
            # the grasped node's position advances by the action and its
            # newest history slot carries the action-induced velocity
            pos_in = pos + onehot * action[None, :]
            vel_in = vel_hist.clone()
            vel_in[grasped, -3:] = action
            edge_feats = edge_features_from_positions(pos_in, edge_index)
            next_vel = predict_velocity(state, vel_in, node_type, edge_index,
                                        edge_feats, edge_mask, normalize)
            if real_world:
                next_vel = edge_length_refine(next_vel, pos, edge_index,
                                              rest_lengths, grasped,
                                              n_steps=refine_steps, lr=refine_lr,
                                              edge_mask=edge_mask)
            next_vel = next_vel.clone()
            next_vel[grasped] = action
            pos = pos + next_vel
            vel_hist = torch.cat([vel_hist[:, 3:], next_vel], -1)
            traj.append(pos)
            vels.append(next_vel)
    if not vels:
        return torch.stack(traj), positions0.new_zeros((0,) + positions0.shape)
    return torch.stack(traj), torch.stack(vels)


def rollout_batched(
    state: dict,
    positions0: torch.Tensor,        # [V, 3]
    init_velocity: torch.Tensor,     # [hist, V, 3]
    node_type: torch.Tensor,         # [V]
    edge_index: torch.Tensor,        # [2, E]
    actions: torch.Tensor,           # [A, S, 3] each candidate's actions
    grasped: int | torch.Tensor,     # an int, or a 0-d integer tensor on the device
    n_steps: int,
    normalize: bool = True,
) -> torch.Tensor:
    """A rollouts from one start, one per action sequence: the counterpart
    of the JAX package's ``jax.vmap`` of ``rollout`` over candidates. The A
    copies of the graph run as one graph of A·V nodes (copy a's edges offset
    by a·V, its grasped node ``grasped + a·V`` moved by its own action), so
    each GNN step is one pass over A·V nodes. Nothing reads a device value
    back to the host, so the whole call can be captured as a CUDA graph (a
    tensor ``grasped`` is read on the device). Returns positions
    [A, S+1, V, 3]."""
    a, v = actions.shape[0], positions0.shape[0]
    dev = positions0.device
    with span("rollout.graph"):
        offsets = torch.arange(a, device=dev) * v
        edges = (edge_index[:, None, :] + offsets[None, :, None]).reshape(2, -1)
        types = node_type.repeat(a)
        handles = offsets + grasped                                  # [A]
        hist = init_velocity.shape[0]
        vel_hist = torch.cat([init_velocity[i] for i in range(hist)], -1).repeat(a, 1)
        pos = positions0.repeat(a, 1)                                # [A·V, 3]
    traj = [pos]
    with torch.no_grad():
        for s in range(min(n_steps, actions.shape[1])):
            with span("rollout.step"):
                act = actions[:, s]                                  # [A, 3]
                # each copy's grasped node advances by its action, and its
                # newest history slot carries the action-induced velocity
                pos_in = pos.index_put((handles,), pos[handles] + act)
                vel_in = vel_hist.clone()
                vel_in[handles, -3:] = act
                edge_feats = edge_features_from_positions(pos_in, edges)
                next_vel = predict_velocity(state, vel_in, types, edges, edge_feats,
                                            normalize=normalize)
                next_vel = next_vel.index_put((handles,), act)
                pos = pos + next_vel
                vel_hist = torch.cat([vel_hist[:, 3:], next_vel], -1)
                traj.append(pos)
    return torch.stack(traj).reshape(-1, a, v, 3).transpose(0, 1)
