"""PointPillars training on tensors: target assignment, losses, the one-cycle
LR schedule and the train step (counterpart of
`lidar_snow_sim_tpu/models/detector_train.py`).

- `assign_targets`: pcdet AxisAlignedTargetAssigner with
  MATCH_HEIGHT=False: per-class BEV rotated-IoU matching with matched and
  unmatched thresholds, every gt force-matching its best anchors (ties
  included), a "don't care" band in between. The full (N, G) IoU matrix
  comes from `ops/rotated_iou.boxes_iou_bev`; the assigned gt rows are
  gathered.
- `detection_loss`: SigmoidFocalClassificationLoss (alpha 0.25, gamma 2),
  WeightedSmoothL1Loss (beta 1/9) on the 7-DoF residual encoding with the
  sin-difference angle trick, and the 2-bin direction cross-entropy;
  weights cls 1.0, loc 2.0, dir 0.2, normalized by each frame's positives.
- `forward_backward`: train-mode forward (`pointpillars.train_forward`),
  assignment, loss and `loss.backward()`; `make_train_step` adds a
  `torch.optim.Adam` step at `schedule(step)`, then commits the BN running
  stats. The running stats are buffers, so Adam never sees them. With
  `data_parallel=True` each rank of the default process group takes its
  slice of the batch: the BN statistics are summed over the ranks
  (differentiably), and the gradients and the metrics are averaged, which
  gives the one-process step on the whole batch because every rank's
  loss divides by its own, equal, share of the batch.
- `onecycle_schedule`: `optax.cosine_onecycle_schedule` as a plain
  function of the step.

gt boxes are fixed-shape (G, 8) rows [x y z dx dy dz heading class] with
class 0 for padding (pcdet's collate convention).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.nn import functional as F

from lidar_snow_sim_tpu_torch.models.pointpillars import (
    PointPillars,
    PointPillarsConfig,
    _true_float32,
    encode_boxes,
    limit_period,
    train_forward,
)
from lidar_snow_sim_tpu_torch.ops.f32 import div
from lidar_snow_sim_tpu_torch.parallel import distributed
from lidar_snow_sim_tpu_torch.ops.rotated_iou import boxes_iou_bev


# ---------------------------------------------------------------------------
# target assignment


def assign_targets(anchors, gt_boxes, cfg: PointPillarsConfig):
    """pcdet AxisAlignedTargetAssigner.assign_targets for one frame.

    anchors: (N, 7) flattened (H, W, A), A class-major then rotation;
    gt_boxes: (G, 8), column 7 the 1-based class id (0 = padding row).

    Returns (cls_labels (N,) int32 in {-1, 0, 1..ncls}, reg_targets (N, 7),
    reg_weights (N,) float32 {0, 1}); -1 marks the ignore band between the
    unmatched and matched thresholds.
    """
    n = anchors.shape[0]
    dev = anchors.device
    nrot = len(cfg.anchor_rotations)
    a = cfg.num_anchors_per_loc
    cls_of_anchor = (torch.arange(n, device=dev) % a) // nrot   # 0-based

    gt_cls = gt_boxes[:, 7].to(torch.int32)            # 1-based, 0 pad
    gt_valid = gt_cls > 0

    iou = boxes_iou_bev(anchors, gt_boxes[:, :7])      # (N, G)
    # anchors may only match valid gts of their own class
    same_cls = (cls_of_anchor[:, None] == (gt_cls[None, :] - 1)) & \
        gt_valid[None, :]
    iou = torch.where(same_cls, iou, -1.0)

    anchor_max = torch.amax(iou, dim=1)
    anchor_arg = torch.argmax(iou, dim=1)              # first of ties
    gt_max = torch.amax(iou, dim=0)

    match_t = torch.tensor(cfg.anchor_match_thresholds, dtype=torch.float32,
                           device=dev)[cls_of_anchor]
    unmatch_t = torch.tensor(cfg.anchor_unmatch_thresholds,
                             dtype=torch.float32, device=dev)[cls_of_anchor]

    # force-match: every gt claims its best anchor(s), ties included
    # (pcdet's anchors_with_max_overlap); overrides the thresholds
    force = (iou == gt_max[None, :]) & (gt_max[None, :] > 0) & \
        gt_valid[None, :]
    force_any = torch.any(force, dim=1)
    force_gt = torch.argmax(torch.where(force, iou + 1.0, -1.0), dim=1)

    pos = (anchor_max >= match_t) | force_any
    neg = (anchor_max < unmatch_t) & ~force_any
    assigned = torch.where(force_any, force_gt, anchor_arg)

    cls_labels = torch.where(
        pos, gt_cls[assigned], torch.where(neg, 0, -1)).to(torch.int32)
    reg_targets = encode_boxes(gt_boxes[assigned, :7], anchors)
    reg_targets = torch.where(pos[:, None], reg_targets, 0.0)
    return cls_labels, reg_targets, pos.to(torch.float32)


def assign_batch(anchors, gt_boxes, cfg: PointPillarsConfig):
    """`assign_targets` frame by frame over (B, G, 8) gt boxes -> (B, N)
    labels, (B, N, 7) targets, (B, N) weights."""
    outs = [assign_targets(anchors, g, cfg) for g in gt_boxes]
    return tuple(torch.stack(t) for t in zip(*outs))


# ---------------------------------------------------------------------------
# losses (pcdet loss_utils semantics)


def sigmoid_focal_loss(logits, one_hot, weights, alpha=0.25, gamma=2.0):
    """pcdet SigmoidFocalClassificationLoss: per-element focal BCE,
    weighted per anchor."""
    p = torch.sigmoid(logits)
    alpha_w = one_hot * alpha + (1 - one_hot) * (1 - alpha)
    pt = one_hot * (1 - p) + (1 - one_hot) * p
    focal = alpha_w * torch.pow(pt, gamma)
    # maximum, not clamp: at a tie it splits the gradient, as JAX's clip
    bce = (torch.maximum(logits, torch.zeros_like(logits))
           - logits * one_hot
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return focal * bce * weights[..., None]


def smooth_l1(diff, beta=1.0 / 9.0):
    ad = torch.abs(diff)
    return torch.where(ad < beta, div(0.5 * ad * ad, beta), ad - 0.5 * beta)


def detection_loss(cls_pred, box_pred, dir_pred, cls_labels, reg_targets,
                   reg_weights, anchors, cfg: PointPillarsConfig):
    """Total pcdet AnchorHeadSingle loss for a batch.

    cls_pred (B, N, ncls), box_pred (B, N, 7), dir_pred (B, N, bins);
    targets from `assign_batch`; anchors (N, 7). Returns (loss, metrics):
    loss, loss_cls, loss_loc, loss_dir and num_pos (positives a frame), all
    0-dim float32 tensors.
    """
    ncls = len(cfg.class_names)
    pos = reg_weights                                   # (B, N)
    pos_norm = torch.clamp_min(torch.sum(pos, dim=1, keepdim=True), 1.0)
    cls_w = ((cls_labels == 0) | (cls_labels > 0)).to(torch.float32)
    cls_w = cls_w / pos_norm
    reg_w = pos / pos_norm

    one_hot = F.one_hot(torch.clamp_min(cls_labels, 0).long(),
                        ncls + 1).to(torch.float32)[..., 1:]
    batch = cls_pred.shape[0]
    cls_loss = div(torch.sum(sigmoid_focal_loss(cls_pred, one_hot, cls_w)),
                   batch)

    # sin-difference angle encoding (pcdet add_sin_difference)
    pr, tr = box_pred[..., 6:7], reg_targets[..., 6:7]
    box_p = torch.cat([box_pred[..., :6], torch.sin(pr) * torch.cos(tr)],
                      dim=-1)
    box_t = torch.cat([reg_targets[..., :6], torch.cos(pr) * torch.sin(tr)],
                      dim=-1)
    loc_loss = div(torch.sum(smooth_l1(box_t - box_p) * reg_w[..., None]),
                   batch) * 2.0

    # direction bins from the decoded gt heading (pcdet get_direction_target)
    rot_gt = reg_targets[..., 6] + anchors[None, :, 6]
    period = 2 * math.pi / cfg.num_dir_bins
    dir_t = torch.floor(div(
        limit_period(rot_gt - cfg.dir_offset, 0.0, 2 * math.pi), period))
    dir_t = torch.clamp(dir_t.long(), 0, cfg.num_dir_bins - 1)
    dir_oh = F.one_hot(dir_t, cfg.num_dir_bins).to(torch.float32)
    ce = -torch.sum(dir_oh * torch.log_softmax(dir_pred, dim=-1), dim=-1)
    dir_loss = div(torch.sum(ce * reg_w), batch) * 0.2

    loss = cls_loss + loc_loss + dir_loss
    return loss, {
        "loss": loss.detach(), "loss_cls": cls_loss.detach(),
        "loss_loc": loc_loss.detach(), "loss_dir": dir_loss.detach(),
        "num_pos": div(torch.sum(pos), batch),
    }


# ---------------------------------------------------------------------------
# LR schedule, train state and step


def onecycle_schedule(total_steps: int, peak: float, pct_start: float = 0.4,
                      div_factor: float = 10.0,
                      final_div_factor: float = 1000.0) -> Callable:
    """`optax.cosine_onecycle_schedule(total_steps, peak, pct_start,
    div_factor, final_div_factor)` as a function of the step count: cosine
    from peak / div_factor up to peak over the first int(pct_start *
    total_steps) steps, then down to peak / (div_factor * final_div_factor)
    at total_steps, constant after."""
    b1, b2 = int(pct_start * total_steps), int(total_steps)
    v0 = peak / div_factor
    v1 = v0 * div_factor
    v2 = v1 * (1.0 / (div_factor * final_div_factor))

    def cosine(start, end, pct):
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)

    def schedule(count: int) -> float:
        if count < b1:
            return cosine(v0, v1, count / b1)
        if count < b2:
            return cosine(v1, v2, (count - b1) / (b2 - b1))
        return v2

    return schedule


@dataclasses.dataclass
class TrainState:
    """The net (parameters and BN running stats), its Adam optimizer and
    the number of steps taken."""

    net: PointPillars
    optimizer: torch.optim.Adam
    step: int = 0


def make_adam(net: PointPillars, lr: float = 3e-3) -> torch.optim.Adam:
    """Adam over the net's learnable parameters, optax.adam's constants
    (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def forward_backward(net: PointPillars, points, valid, gt_boxes, anchors,
                     reduce=None):
    """One batch through the training forward (true float32 convolutions
    where the config computes in float32), target assignment, the loss
    and `loss.backward()` on the net's device; the gradients accumulate in
    the parameters' `.grad`. anchors: (N, 7) on that device. `reduce` goes
    to `train_forward`. Returns (loss, metrics, running stats after the
    batch, labels)."""
    cfg = net.cfg
    with _true_float32():
        cls, box, dir_, stats = train_forward(points, valid, net,
                                              device=net.device,
                                              reduce=reduce)
        with torch.no_grad():
            labels, reg_t, reg_w = assign_batch(anchors, gt_boxes, cfg)
        loss, metrics = detection_loss(cls, box, dir_, labels, reg_t,
                                       reg_w, anchors, cfg)
        loss.backward()
    return loss.detach(), metrics, stats, labels


def make_train_step(cfg: PointPillarsConfig, anchors, schedule=None,
                    data_parallel: bool = False, make_optimizer=make_adam):
    """(step, init_state) after the JAX package's `make_train_step`.

    anchors: (H, W, A, 7) from `generate_anchors` (numpy or tensor);
    schedule: step -> LR (default a constant 3e-3). `step(state, points,
    valid, gt_boxes)` runs one step on the net's device (`forward_backward`,
    Adam, then the running stats are committed) and returns (state,
    metrics); step `it` uses `schedule(it)`, as optax reads its count
    before incrementing it. `make_optimizer(net, lr)` builds the optimizer
    (default Adam, `make_adam`), as the JAX package's step takes an optax
    optimizer. With `data_parallel`, this process is one rank
    of the default process group and its arguments are the rank's equal
    share of the batch (see the module docstring); the metrics are the
    whole batch's.
    """
    schedule = schedule or (lambda it: 3e-3)
    flat = torch.as_tensor(anchors, dtype=torch.float32).reshape(-1, 7)
    on_device: dict = {}

    def step(state: TrainState, points, valid, gt_boxes):
        net = state.net
        if net.device not in on_device:
            on_device[net.device] = flat.to(net.device)
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.step)
        state.optimizer.zero_grad(set_to_none=True)
        _, metrics, stats, _ = forward_backward(
            net, points, valid, gt_boxes, on_device[net.device],
            reduce=distributed.all_reduce_sum if data_parallel else None)
        if data_parallel:
            distributed.average_gradients(net.parameters())
            metrics = distributed.mean_over_ranks(metrics)
        state.optimizer.step()
        with torch.no_grad():
            for name, value in stats.items():
                net.get_buffer(name).copy_(value)
        state.step += 1
        return state, metrics

    def init_state(net: PointPillars) -> TrainState:
        return TrainState(net, make_optimizer(net, schedule(0)))

    return step, init_state
