"""Multi-scene training: S scenes of one shape, trained as one suite (port of
``nvfi_tpu/parallel/multi_scene.py``).

The scenes share every shape-affecting config value (the InDoorObj suite's
six do: its configs differ only in ``train_iters``, the wandb name and the
``segmentation:`` block), so one meta serves all.  Each param leaf and
each Adam moment is stacked on a leading scene axis (S, ...).  JAX
``vmap``s the single-scene step over that axis; here the single-scene
:func:`train.trainer.make_train_step` runs on each scene's contiguous views
in turn (``x[i].detach()``: leaves that share the stacked storage, so the
in-place Adam update lands there), since the kernels take one scene's
planes.

Stage events follow the JAX class: the alpha-mask event builds a mask a scene
and crops every scene to the **union** of their occupied boxes (one shape for
all), the upsample resizes all alike, each rebuilds a fresh Adam a scene; turbo
probes each scene's budgets and shares the **max** (every scene keeps its
active blocks), the shade capped at the config's value; a running-max
``dropped_blocks`` / ``dropped_shade`` pair a scene certifies exactness.

With a mesh the scenes are split over the ranks, S / D each, with no
communication inside a step.  The union box, the shared budgets, the
counters and the logged metrics cross the ranks with ``all_reduce`` (min,
max, sum).  On a ``('data', 'model')`` mesh the scenes are split over the
data axis and every model rank of a data row holds that row's scenes whole,
as JAX's ``P('data')`` placement of the scene axis does; the metrics are
summed over the data axis alone.  Every rank draws the frame choices of all S scenes from one
numpy ``RandomState``, as JAX does, and each scene's own draws come from a
generator seeded by (seed, scene), so that a meshed run draws what one
process draws.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..device import resolve_device
from ..fields import kplane
from ..train import turbo as turbo_mod
from ..train.trainer import (TrainHP, draw_train_inputs, exp_schedule, init_counters,
                             make_train_step, n_to_reso, rank_seed)
from . import mesh as parallel_mesh


def stack_scenes(scene_params: list):
    """Stack per-scene param trees along a new leading scene axis."""
    first = scene_params[0]
    if isinstance(first, dict):
        return {k: stack_scenes([p[k] for p in scene_params]) for k in first}
    if isinstance(first, (list, tuple)):
        return [stack_scenes([p[i] for p in scene_params]) for i in range(len(first))]
    if first is None:
        return None
    return torch.stack(scene_params)


def unstack_scenes(stacked, n_scenes: int) -> list:
    """Scene i's tree of ``stacked``: views that share its storage."""
    return [kplane.map_params(lambda x, i=i: x[i].detach(), stacked) for i in range(n_scenes)]


def _scene_rows(tree, lo: int, hi: int):
    return kplane.map_params(lambda x: x[lo:hi].contiguous(), tree)


class MultiSceneTrainer:
    """The single-scene train step over a stack of scenes (JAX: ``vmap``).

    ``datasets``: one loader 7-tuple a scene, all with the same (H, W, focal)
    and frame count.  ``aabbs``: optional per-scene (2, 3) world boxes; each
    scene is moved into one canonical box by translating its cameras (every
    split's), the box taking the per-axis largest extent; ``scene_offset(i)``
    maps back.  ``mesh``: S / D scenes a rank (D the data axis' size; the
    model ranks of a data row hold the same scenes), S must divide by D.
    ``draws``, if given, is called as ``draws(step, meta, hp, scene)`` for a
    scene's :class:`train.trainer.TrainDraws`; by default they come from the
    scene's own generator.
    """

    def __init__(self, cfg, datasets: list, mesh=None, mode: str = "static_dynamic",
                 seed: int = 0, aabbs=None, device="cuda", draws=None):
        self.cfg = cfg
        self.hp = TrainHP.from_cfg(cfg)
        self.mode = mode
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.n_scenes = len(datasets)
        n_ranks, rank = (mesh.shape["data"], mesh.index("data")) if mesh is not None else (1, 0)
        if self.n_scenes % n_ranks:
            raise ValueError(f"{self.n_scenes} scenes do not divide over {n_ranks} ranks")
        per = self.n_scenes // n_ranks
        self.scenes = range(rank * per, (rank + 1) * per)  # this rank's scenes
        self._draws = draws
        self.events = []
        self.counter_reads = []  # (tag, the per-scene maxima) of every check_counters

        _, _, times0, counts0, _, _, (H, W, focal) = datasets[0][:7]
        self.H, self.W, self.focal = int(H), int(W), float(focal)
        split = "train"
        self.n_frames = counts0[split]

        self.scene_offsets = np.zeros((self.n_scenes, 3), np.float32)
        if aabbs is not None:
            boxes = np.asarray(aabbs, dtype=np.float64)  # (S, 2, 3)
            assert boxes.shape == (self.n_scenes, 2, 3), boxes.shape
            self.scene_offsets = boxes.mean(axis=1).astype(np.float32)
            half = (boxes[:, 1] - boxes[:, 0]).max(axis=0) / 2.0  # per-axis max
            aabb = np.stack([-half, half])
            datasets = [self._translate_dataset(d, self.scene_offsets[i])
                        for i, d in enumerate(datasets)]
        else:
            aabb = np.stack([np.asarray(cfg.nvfi.bbox_x), np.asarray(cfg.nvfi.bbox_y),
                             np.asarray(cfg.nvfi.bbox_z)], axis=-1)
        res0 = n_to_reso(int(cfg.nvfi.N_voxel_init), aabb)
        near_far = (float(cfg.dataset.near), float(cfg.dataset.far))
        self.meta = kplane.meta_from_cfg(cfg.nvfi, aabb, res0, near_far)

        self.params = stack_scenes([
            kplane.init_params(torch.Generator().manual_seed(rank_seed(seed, i)), self.meta,
                               device=self.device) for i in self.scenes])
        self._fresh_state()

        dev = self.device
        ours = [datasets[i] for i in self.scenes]
        self.poses_host = np.stack([np.stack([np.asarray(p, np.float32) for p in d[1][split]])
                                    for d in ours])  # (S_r, F, 4, 4)
        self.images = torch.stack([torch.as_tensor(np.asarray(d[0][split], np.float32))
                                   for d in ours]).to(dev)  # (S_r, F, H, W, 3)
        self.poses = torch.as_tensor(self.poses_host).to(dev)
        self.times = torch.stack([torch.as_tensor(np.asarray(d[2][split], np.float32))
                                  for d in ours]).to(dev)  # (S_r, F)
        self.times0 = np.asarray(times0[split], np.float32)  # scene 0's, on every rank

        self.rng = np.random.RandomState(seed)  # the frame choices of every scene, as JAX's
        self.generators = [torch.Generator(device=dev).manual_seed(rank_seed(seed + 1, i))
                           for i in self.scenes]
        self.global_step = 0
        n_up = len(self.hp.upsamp_list)
        self.n_voxel_list = exp_schedule(self.hp.n_voxel_init, self.hp.n_voxel_final, n_up)
        self.keyframe_list = exp_schedule(self.meta.num_keyframes, self.hp.num_keyframes_end,
                                          n_up)
        self.reso_mask = tuple(self.meta.grid_size)
        self.l1_base = self.hp.L1_weight_initial
        self.l1_step0 = 0
        # per-scene masks, each key stacked (S_r, ...); None until the first
        # alpha event.  They prune eval renders always, and training samples
        # once turbo engages there.
        self.alpha_states = None
        self.turbo = bool(cfg.nvfi.get("turbo", False))
        self._shade_cap = float(self.meta.shade_fraction)
        self._build_step()

    # -- state ----------------------------------------------------------------

    def _fresh_state(self):
        """A fresh Adam a scene and fresh counters (at every stage event)."""
        self.opt_state = {"m": kplane.map_params(torch.zeros_like, self.params),
                          "v": kplane.map_params(torch.zeros_like, self.params),
                          "step": [0] * len(self.scenes)}
        self.counters = [init_counters(self.device) for _ in self.scenes]

    def assign_state(self, params, opt_state=None):
        """Put stacked state of all S scenes in place (the port's layout:
        ``train.checkpoint.multi_scene_state_from_numpy``); a rank keeps its
        own scenes' rows."""
        lo, hi = self.scenes.start, self.scenes.stop
        self.params = _scene_rows(params, lo, hi)
        if opt_state is None:
            self._fresh_state()
        else:
            self.opt_state = {"m": _scene_rows(opt_state["m"], lo, hi),
                              "v": _scene_rows(opt_state["v"], lo, hi),
                              "step": [int(s) for s in opt_state["step"][lo:hi]]}

    def _local(self, i: int) -> int:
        if i not in self.scenes:
            raise ValueError(f"scene {i} is not on this rank (it holds {list(self.scenes)})")
        return i - self.scenes.start

    def scene_params(self, i: int):
        """Scene i's params: views of the stacked leaves."""
        j = self._local(i)
        return kplane.map_params(lambda x: x[j].detach(), self.params)

    def scene_alpha_state(self, i: int):
        """Scene i's mask (None before the first alpha event)."""
        if self.alpha_states is None:
            return None
        j = self._local(i)
        return {k: v[j] for k, v in self.alpha_states.items()}

    def scene_offset(self, i: int) -> np.ndarray:
        """Canonical -> world translation of scene i (world = canonical + offset)."""
        return self.scene_offsets[i]

    def _use_alpha(self) -> bool:
        return bool(self.meta.train_occupancy_prune and self.alpha_states is not None)

    def _build_step(self):
        self._step = make_train_step(self.meta, self.hp, self.mode, self.H, self.W, self.focal,
                                     use_alpha=self._use_alpha(), device=self.device)

    def _keyframe_frames(self):
        delta = self.meta.time_scale_factor
        base = np.round(np.clip(self.times0 / delta, 0, self.meta.num_keyframes - 1)) * delta
        key_frames = np.where(np.isclose(self.times0, base))[0]
        return key_frames if len(key_frames) else np.arange(self.n_frames)

    def _restack(self, scene_params: list):
        """Re-stack after a stage transition, with a fresh Adam a scene, as
        the reference rebuilds Adam at stage boundaries."""
        self.params = stack_scenes(scene_params)
        self._fresh_state()

    def _gather(self, values: list) -> np.ndarray:
        """(S,) float64 of this rank's per-scene numbers, summed over the
        ranks into their scenes' places (zeros elsewhere)."""
        full = np.zeros(self.n_scenes)
        full[self.scenes.start:self.scenes.stop] = [float(v) for v in values]
        return parallel_mesh.reduce_values(self.mesh, full, "sum",
                                           None if self.mesh is None else "data")

    def _check_ranks(self, what: str):
        if self.mesh is not None:
            parallel_mesh.check_replicated(self.mesh, [], what, extra=(self.meta,))

    # -- stage events ---------------------------------------------------------

    def stage_alpha(self, it: int):
        """A mask a scene and the crop of every scene to the union of their
        occupied boxes (the min and max over the scenes, and the ranks)."""
        if int(np.prod(self.meta.grid_size)) < 256 ** 3:
            self.reso_mask = tuple(self.meta.grid_size)
        scenes = unstack_scenes(self.params, len(self.scenes))
        vols, boxes = [], []
        for p in scenes:
            state, box = kplane.update_alpha_mask(p, self.meta, self.reso_mask,
                                                  device=self.device)
            vols.append(state)
            boxes.append(np.asarray(box))
        dtype = boxes[0].dtype
        lo = parallel_mesh.reduce_values(self.mesh, np.min([b[0] for b in boxes], axis=0), "min")
        hi = parallel_mesh.reduce_values(self.mesh, np.max([b[1] for b in boxes], axis=0), "max")
        union = np.stack([lo, hi]).astype(dtype)
        shrunk = [kplane.shrink(p, self.meta, union) for p in scenes]
        self.meta = shrunk[0][1]
        self.alpha_states = {k: torch.stack([v[k] for v in vols]) for k in vols[0]}
        self._restack([p for p, _ in shrunk])
        if it == tuple(self.hp.update_alphamask_list)[0]:
            self.l1_base = self.hp.L1_weight_reset
            self.l1_step0 = it + 1
        self._reprobe_turbo(f"alpha@{it}")
        self._build_step()
        self._log_event(it, "alpha", union)

    def _reprobe_turbo(self, tag: str):
        """Engage or re-calibrate turbo for the current meta: each scene's
        probe, the max over the scenes (and ranks) shared, the shade capped at
        the config's value."""
        if not (self.turbo and self.alpha_states is not None):
            return
        budgets, shades = [], []
        for j in range(len(self.scenes)):
            b, s = turbo_mod.measure_block_budget(
                self.meta, {k: v[j] for k, v in self.alpha_states.items()},
                self.poses_host[j], self.H, self.W, self.focal, self.hp.n_rays,
                with_shade=True)
            budgets.append(b)
            shades.append(s)
        ours = np.zeros(self.n_scenes)
        ours[self.scenes.start:self.scenes.stop] = budgets
        every = parallel_mesh.reduce_values(self.mesh, ours, "max")
        budget = float(every.max())
        shade = float(parallel_mesh.reduce_values(self.mesh, max(shades), "max"))
        self.meta = replace(self.meta, train_occupancy_prune=True, block_budget=budget,
                            shade_fraction=min(shade, self._shade_cap))
        if self.is_main:
            print(f"[turbo] {tag}: shared block_budget={self.meta.block_budget:.3f} (per-scene "
                  f"{['%.3f' % b for b in every]}) shade_fraction="
                  f"{self.meta.shade_fraction:.3f}", flush=True)

    def check_counters(self, tag: str) -> dict:
        """The per-scene running-max exactness counters, (S,) each, over all
        ranks: ``dropped_blocks`` > 0 on any scene means the shared budget
        dropped active samples there."""
        db = np.zeros(self.n_scenes)
        ds = np.zeros(self.n_scenes)
        sl = slice(self.scenes.start, self.scenes.stop)
        db[sl] = [float(c["dropped_blocks"]) for c in self.counters]
        ds[sl] = [float(c["dropped_shade"]) for c in self.counters]
        db = parallel_mesh.reduce_values(self.mesh, db, "max")
        ds = parallel_mesh.reduce_values(self.mesh, ds, "max")
        self.counter_reads.append((tag, db.tolist(), ds.tolist()))
        if self.is_main and db.max() > 0:
            print(f"[turbo] !!! EXACTNESS VIOLATION at {tag}: per-scene max dropped_blocks="
                  f"{db.tolist()}: the shared block budget dropped active samples; raise "
                  "nvfi.turbo_budget or disable turbo", flush=True)
        elif self.is_main and ds.max() > 0:
            print(f"[turbo] stage truncation at {tag}: per-scene max dropped_shade="
                  f"{ds.tolist()} (accepted by shade cap {self._shade_cap})", flush=True)
        return {"max_dropped_blocks": db, "max_dropped_shade": ds}

    def stage_upsample(self, it: int):
        """Every scene resized to the schedule's next grid and keyframes."""
        n_vox = self.n_voxel_list.pop(0)
        res_cur = n_to_reso(n_vox, self.meta.aabb_np)
        kf_cur = self.keyframe_list.pop(0)
        scenes = unstack_scenes(self.params, len(self.scenes))
        upsampled = [kplane.upsample(p, self.meta, res_cur, kf_cur) for p in scenes]
        self.meta = upsampled[0][1]
        self._restack([p for p, _ in upsampled])
        if self.meta.train_occupancy_prune:
            self._reprobe_turbo(f"upsample@{it}")  # the sample axis refined
        self._build_step()
        self._log_event(it, "upsample")

    def _log_event(self, it: int, kind: str, union=None):
        self._check_ranks(f"{kind}@{it}")
        event = {"it": it, "kind": kind, "grid": tuple(self.meta.grid_size),
                 "keyframes": self.meta.num_keyframes,
                 "aabb": [list(r) for r in self.meta.aabb],
                 "union": None if union is None else union.tolist(),
                 "block_budget": self.meta.block_budget,
                 "shade_fraction": self.meta.shade_fraction}
        self.events.append(event)
        if self.is_main:
            print(f"[multi_scene] it={it} {kind}: grid {event['grid']}, keyframes "
                  f"{event['keyframes']}, aabb {event['aabb']}, block_budget "
                  f"{self.meta.block_budget:.4f}, shade_fraction "
                  f"{self.meta.shade_fraction:.4f}", flush=True)

    # -- the loop ---------------------------------------------------------------

    def _next_draws(self, it: int, j: int, pools):
        i = self.scenes[j]
        if self._draws is not None:
            return self._draws(it, self.meta, self.hp, i)
        return draw_train_inputs(self.generators[j], self.meta, self.hp, self.H, self.W, None,
                                 *pools)

    def _pools(self, key_frames):
        return (torch.arange(self.n_frames, device=self.device),
                torch.as_tensor(key_frames, dtype=torch.int64, device=self.device))

    def step(self, it: int, f_idx, k_idx, pools) -> dict:
        """One iteration of every scene of this rank: the metrics, (S_r,)
        tensors on the device."""
        use_alpha = self._use_alpha()
        views = unstack_scenes(self.params, len(self.scenes))
        m_views = unstack_scenes(self.opt_state["m"], len(self.scenes))
        v_views = unstack_scenes(self.opt_state["v"], len(self.scenes))
        out = []
        for j, i in enumerate(self.scenes):
            opt = {"m": m_views[j], "v": v_views[j], "step": self.opt_state["step"][j]}
            alpha = ({k: v[j] for k, v in self.alpha_states.items()} if use_alpha else None)
            _, opt, self.counters[j], metrics = self._step(
                views[j], opt, self.counters[j], self._next_draws(it, j, pools), int(f_idx[i]),
                int(k_idx[i]), it, self.poses[j], self.images[j], self.times[j], self.l1_base,
                self.l1_step0, alpha)
            self.opt_state["step"][j] = opt["step"]
            out.append(metrics)
        return {k: torch.stack([torch.as_tensor(m[k], dtype=torch.float32,
                                                device=self.device) for m in out])
                for k in out[0]}

    def gather_metrics(self, metrics: dict) -> dict:
        """(S,) numpy arrays of every scene's metrics (a collective with a mesh)."""
        return {k: self._gather(v.tolist()) for k, v in sorted(metrics.items())}

    def train(self, iters: int, key_frames=None, log_fn=None) -> dict:
        """Run the shared schedule up to ``iters`` iterations.  ``log_fn(m)``
        every ``print_every`` iterations on rank 0, with (S,) arrays and the
        PSNRs; returns the last iteration's metrics, (S,) numpy arrays."""
        n = self.n_scenes
        if key_frames is None:
            key_frames = self._keyframe_frames()
        pools = self._pools(key_frames)
        metrics = {}
        for it in range(self.global_step, iters):
            f_idx = self.rng.randint(self.n_frames, size=n)
            k_idx = key_frames[self.rng.randint(len(key_frames), size=n)]
            metrics = self.step(it, f_idx, k_idx, pools)
            if it % self.hp.print_every == 0:
                m = self.gather_metrics(metrics) | {"it": it}
                for src, dst in (("rgb_loss_0", "psnr_0"), ("rgb_loss_t", "psnr_t")):
                    mse = np.maximum(m[src], 1e-12)
                    m[dst] = np.where(mse < 1.0 - 1e-9, -10.0 * np.log10(mse), 0.0)
                if log_fn and self.is_main:
                    log_fn(m)
            self.global_step = it + 1

            if it in self.hp.update_alphamask_list and self.mode in ("static",
                                                                      "static_dynamic"):
                if self._use_alpha():
                    self.check_counters(f"pre-alpha@{it}")
                self.stage_alpha(it)
                key_frames = self._keyframe_frames()
                pools = self._pools(key_frames)
            if it in self.hp.upsamp_list and self.mode in ("static", "static_dynamic"):
                if self._use_alpha():
                    self.check_counters(f"pre-upsample@{it}")
                self.stage_upsample(it)
                key_frames = self._keyframe_frames()
                pools = self._pools(key_frames)
        if self._use_alpha():
            self.check_counters(f"train-end@{self.global_step}")
        return self.gather_metrics(metrics) if metrics else {}

    @staticmethod
    def _translate_dataset(dataset, offset):
        """Shift every camera of every split by -offset (world -> canonical):
        the offset belongs to the scene, not to a split."""
        imgs, poses, times, counts = dataset[0], dataset[1], dataset[2], dataset[3]
        new_poses = {}
        for split, plist in poses.items():
            shifted = []
            for p in plist:
                p = np.array(p, np.float32).copy()
                p[:3, 3] -= offset
                shifted.append(p)
            new_poses[split] = shifted
        return (imgs, new_poses, times, counts) + tuple(dataset[4:])
