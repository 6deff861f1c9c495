"""How many of the lift's near ties K3 and its plain version route apart.

At a point whose two largest selected scores nearly tie, or a channel whose
largest (smallest) selected value has a value of a rank that reads other
taps within ``NEAR_TIE_RTOL`` of it, the cotangent of the score max (of
the max, of the min) goes to the rank that holds the extreme: where K3 and
``view_scan.lift_topk_bwd_plain`` form a rank's combined ``f`` differently,
they may pick different ranks there. This script counts, on the inputs
that one training step gives K3 in the map's lift (batch 2, bf16) of the
flagship (``train_full1chip_exhaustive``) and of ``chip_smoke.py`` phase
7j's stream with the max and min and scan unweighted (the capture of
``tests/torch_k3_ab.py``), the near-tie entries of each kind and those of
them that the two route to different ranks.

Each kind (score max, max, min) is counted on its own: a cotangent that is
1 at that kind's near-tie entries and 0 elsewhere, so that each entry of
``d stack`` sums at most the few tap-weighted shares of one point. The
points are taken in rounds of points whose selected ranks' taps share no
pixel (each round keeps the points that are the lowest index at every
pixel they read), and in each round K3 and the plain version run on those
points alone; an entry routes apart where the two ``d stack`` differ in a
bit at one of its point's tap pixels, in its channel (the score bins' for
the score max). ``--tree`` runs another checkout's tree (its
``snap_tpu_torch``, ``chip_smoke.py`` and ``tests/torch_k3_ab.py``), so
that a parent can be counted. Card only:

    python3 tests/torch_c10_ties.py [--tree checkout_check/parent]

One JSON line per row on stdout and in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

# The near ties of chip_smoke.py before ROADMAP C10 was closed: a gap
# within this share of the extreme's size (at least 1).
NEAR_TIE_RTOL = 1e-4


def near_ties(view_scan, args, kw, chunk: int = 131_072):
  """Masks of the near-tie entries: the score max's ``[B, N]`` (weighted
  layouts with K >= 2) and the max's and min's ``[B, N, D]`` (layouts with
  them); None for a kind the layout lacks. Exact ties of ranks that read
  the same taps with the same weights are not near ties."""
  stack, view_idx, p2d, select, depth, _ = args
  dim = kw['dim']
  weighted = stack.shape[-1] > dim
  add_minmax = kw.get('add_minmax', False)
  lift_kw = {k: kw[k] for k in ('h', 'w', 'dim', 'depth_min_max')}
  last = torch.tensor([kw['h'] - 1, kw['w'] - 1], dtype=p2d.dtype,
                      device=p2d.device)
  b, n, k = view_idx.shape
  masks = {}
  if weighted and k >= 2:
    masks['score_max'] = torch.zeros((b, n), dtype=torch.bool,
                                     device=stack.device)
  if add_minmax:
    for kind in ('max', 'min'):
      masks[kind] = torch.zeros((b, n, dim), dtype=torch.bool,
                                device=stack.device)
  if not masks:
    return masks
  for lo in range(0, n, chunk):
    part = slice(lo, lo + chunk)
    ranks = view_scan._lift_ranks(stack, view_idx[:, part], p2d[:, part],
                                  select[:, part], depth[:, part], **lift_kw)
    if 'score_max' in masks:
      top = torch.stack([r.score for r in ranks], -1).topk(2, -1).values
      gap = top[..., 0] - top[..., 1]
      masks['score_max'][:, part] = (
          (top[..., 1] > view_scan.NEG_INF / 2) & (gap > 0)
          & (gap <= NEAR_TIE_RTOL * top[..., 0].abs().clamp(min=1.0)))
    if add_minmax:
      sel = select[:, part, :, None]
      f = torch.stack([r.f[..., :dim] for r in ranks], 2)  # [B, n, K, D]
      del ranks
      vi = view_idx[:, part]
      pts = torch.minimum(torch.clamp(p2d[:, part] - 0.5, min=0), last)
      same = (vi[..., :, None] == vi[..., None, :]) & (
          pts[..., :, None, :] == pts[..., None, :, :]).all(-1)
      for kind, sign in (('max', 1.0), ('min', -1.0)):
        v = torch.where(sel, sign * f, -torch.inf)
        top, first = v.max(2)
        same_taps = torch.gather(
            same, 3, first[:, :, None, :].expand(-1, -1, v.shape[2], -1))
        masks[kind][:, part] = ((top[:, :, None] - v <= NEAR_TIE_RTOL
                                 * top.abs().clamp(min=1.0)[:, :, None])
                                & ~same_taps).any(2)
  return masks


def tap_pixels(view_idx, p2d, select, kw, rows):
  """``[P, K, 4]`` flat pixel (row * W + col of the stack) of each tap of
  each rank of points ``rows`` of one example, and ``[P, K]`` selection."""
  last = torch.tensor([kw['h'] - 1, kw['w'] - 1], dtype=p2d.dtype,
                      device=p2d.device)
  lower = torch.floor(torch.minimum(torch.clamp(p2d[rows] - 0.5, min=0),
                                    last)).long()
  row0 = view_idx[rows].long() * (kw['h'] + 1) + lower[..., 0]
  col0 = lower[..., 1]
  width = kw['w'] + 1
  taps = torch.stack([(row0 + a) * width + col0 + e
                      for a in (0, 1) for e in (0, 1)], -1)
  return taps, select[rows]


def disjoint_rounds(taps, sel, num_pixels):
  """Rounds of point indices (into ``taps``) whose selected taps share no
  pixel: each round keeps the points that are the lowest remaining index
  at every pixel they read."""
  left = torch.arange(taps.shape[0], device=taps.device)
  rounds = []
  while left.numel():
    t = taps[left]
    s = sel[left][..., None].expand_as(t)
    owner = torch.full((num_pixels,), taps.shape[0], device=taps.device)
    idx = left[:, None, None].expand_as(t)
    owner.scatter_reduce_(0, t[s], idx[s], 'amin')
    mine = torch.where(s, owner[t] == idx, True).all(-1).all(-1)
    rounds.append(left[mine])
    left = left[~mine]
  return rounds


def count_kind(kernels, view_scan, args, kw, kind, mask):
  """(near-tie entries of ``kind``, those K3 and the plain version route
  apart, rounds run)."""
  stack, view_idx, p2d, select, depth, g_stats = args
  dim = kw['dim']
  at_max = dim * (1 + kw.get('use_variance', True))
  channels = {'max': slice(at_max, at_max + dim),
              'min': slice(at_max + dim, at_max + 2 * dim),
              'score_max': slice(g_stats.shape[-1] - 1, None)}[kind]
  d_channels = (slice(dim, None) if kind == 'score_max' else
                slice(0, dim))
  bits = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
          torch.float32: torch.int32}[stack.dtype]
  entries = apart = num_rounds = 0
  for b in range(stack.shape[0]):
    m = mask[b] if kind != 'score_max' else mask[b][:, None]
    rows = m.any(-1).nonzero()[:, 0]
    if not rows.numel():
      continue
    entries += int(m.sum())
    taps, sel = tap_pixels(view_idx[b], p2d[b], select[b], kw, rows)
    for chosen in disjoint_rounds(taps, sel, stack.shape[1] * stack.shape[2]):
      num_rounds += 1
      pts = rows[chosen]
      g = torch.zeros((1, pts.numel(), g_stats.shape[-1]),
                      dtype=g_stats.dtype, device=g_stats.device)
      g[0, :, channels] = m[pts].to(g.dtype)
      sub = (stack[b:b + 1], view_idx[b:b + 1, pts], p2d[b:b + 1, pts],
             select[b:b + 1, pts], depth[b:b + 1, pts], g)
      got = kernels.lift_topk_bwd(*sub, **kw, selected=int(sub[3].sum()))
      want = view_scan.lift_topk_bwd_plain(*sub, **kw)
      differ = (got[0].view(bits) != want[0].view(bits))[..., d_channels]
      differ = differ.reshape(-1, differ.shape[-1])  # [pixels, channels]
      t, s = taps[chosen], sel[chosen]
      hit = differ[t.reshape(-1)].reshape(*t.shape, -1)  # [P, K, 4, ch]
      hit = (hit & s[..., None, None]).any(1).any(1)  # [P, ch]
      if kind == 'score_max':
        hit = hit.any(-1, keepdim=True)
      apart += int((hit & m[pts]).sum())
  return entries, apart, num_rounds


def main() -> int:
  parser = argparse.ArgumentParser()
  parser.add_argument('--tree', default=str(
      pathlib.Path(__file__).resolve().parents[1]))
  parser.add_argument('--out', default='chiprun_out/c10_ties.json')
  opts = parser.parse_args()
  if not torch.cuda.is_available():
    print('torch_c10_ties: needs a CUDA card', file=sys.stderr)
    return 1
  tree = pathlib.Path(opts.tree).resolve()
  sys.path[:0] = [str(tree), str(tree / 'tests')]
  import torch_k3_ab  # pylint: disable=g-import-not-at-top
  from snap_tpu_torch.ops import kernels  # pylint: disable=g-import-not-at-top
  from snap_tpu_torch.ops import view_scan  # pylint: disable=g-import-not-at-top
  kernels.load_library()
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True).stdout.strip()
  out = pathlib.Path(opts.out)
  out.parent.mkdir(parents=True, exist_ok=True)
  results = []
  for row in torch_k3_ab.ROWS:
    (args, kw), = torch_k3_ab.step_inputs(row)
    kw = {k: v for k, v in kw.items() if k != 'selected'}
    with torch.no_grad():
      masks = near_ties(view_scan, args, kw)
      counts = {}
      for kind, mask in masks.items():
        entries, apart, rounds = count_kind(kernels, view_scan, args, kw,
                                            kind, mask)
        counts[kind] = dict(near_ties=entries, routed_apart=apart,
                            rounds=rounds)
    result = dict(row=row, tree=str(tree), stack=list(args[0].shape),
                  ranks=list(args[1].shape), selected=int(args[3].sum()),
                  counts=counts, card=smi)
    results.append(result)
    print(json.dumps(result), flush=True)
    out.write_text('\n'.join(json.dumps(r) for r in results) + '\n')
    del args, masks
    torch.cuda.empty_cache()
  return 0


if __name__ == '__main__':
  sys.exit(main())
