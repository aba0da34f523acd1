"""Device-mesh sharding of the voice bank and of the offline chain, on
torch.distributed.

Port of cpp_audio_tpu/parallel/mesh.py. The reference has no multi-device
concept: its parallelism is threads and lock-free queues in one process
(SURVEY §2.9). Here the voice axis is data-parallel: each rank renders its
shard of the voice bank, and the "mix to output bus" (the reference's serial
`buffer[i] += voice.imag()`, gen.crtp.h:350-378) is an all-reduce of the
(T, C) block. Analysis frames and tracked-render rows are sequence-parallel.

JAX runs one process that drives every device of a `Mesh` through
`shard_map`. This port is SPMD, one process per device (as `torchrun` starts
them): every rank calls the same function with the same arguments, and a
`torch.distributed.device_mesh.DeviceMesh` names the ranks. The pieces map so:

  * `in_specs=P(axis)`: rank r of the axis takes the contiguous rows
    [r*V/n, (r+1)*V/n) of each table; `P()`: every rank holds the value;
  * `psum`: an in-place `all_reduce` (SUM); `all_gather`: a gather into one
    (n*rows, ...) tensor in rank order; `ppermute`: `batch_isend_irecv`
    (a ring of one takes its own head, as JAX's `perm=[(0, 0)]`);
  * `out_specs=P()`: every rank returns the whole result;
  * `device_put` onto another device group: a broadcast from the first
    rank of the sending group;
  * `jit` and `compiled_text()`: eager calls; `step.collective_counts()`
    counts the collectives of one chain step (COUNTS, kept by this
    module's own collective helpers) where JAX's dry run counted them in
    the compiled HLO (`__graft_entry__.py:107-111`).

On "cuda" the process group is NCCL, on the CPU gloo; each rank works on
its current CUDA device. Nothing falls back: no CPU when there is no card,
no gloo when NCCL fails, no plain renderer when the kernel fails. Importing
this module starts no process group; `default_mesh` and `default_mesh_2d`
start one when none exists.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..analysis import chain as chain_mod
from ..analysis import device_tracker
from ..analysis import resynth as resynth_mod
from ..core.voices import NEVER, NoteSchedule, round_up
from ..models import resynth_bank, sine_synth, voicebank
from ..ops import stft as stft_ops

# collectives issued by this module's helpers, by kind; a chain step's
# share is step.collective_counts()
COUNTS = dict.fromkeys(("all_reduce", "all_gather", "broadcast", "p2p"), 0)

# torch 2.13 names the gather into one tensor all_gather_single and warns on
# the older all_gather_into_tensor; earlier versions have only the latter
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
ALL_GATHER_NAME = _ALL_GATHER.__name__

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(dev: torch.device) -> str:
    if dev.type not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {dev}")
    return _BACKENDS[dev.type]


def _rank_device(device) -> torch.device:
    """The rank's device: "cuda" without an index is the current device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _ensure_group(device) -> None:
    """Start the default process group if there is none: from torchrun's
    env:// variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) when they
    are set, on the CUDA device LOCAL_RANK; else a one-rank group in this
    process. NCCL for "cuda", gloo for the CPU."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    backend = _backend(dev)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def _mesh_device(mesh: DeviceMesh, device) -> torch.device:
    dev = _rank_device(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, device is {dev}")
    return dev


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    COUNTS["all_reduce"] += 1
    return x


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(rows, ...) on each rank -> (n*rows, ...), in the group's rank order."""
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _ALL_GATHER(out, x.contiguous(), group=group)
    COUNTS["all_gather"] += 1
    return out


def _broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """In-place broadcast from the global rank `src`."""
    dist.broadcast(x, src=src, group=group)
    COUNTS["broadcast"] += 1
    return x


def _ring_from_next(head: torch.Tensor, group) -> torch.Tensor:
    """Each rank d sends `head` to rank d-1 and returns what rank d+1 sent
    (JAX's ppermute with perm [(d, d-1)]). torch's send takes no message to
    the sender itself, so a ring of one returns its own head."""
    n = dist.get_world_size(group)
    COUNTS["p2p"] += 1
    if n == 1:
        return head.clone()
    d = dist.get_rank(group)
    got = torch.empty_like(head)
    ops = [dist.P2POp(dist.isend, head.contiguous(),
                      dist.get_global_rank(group, (d - 1) % n), group),
           dist.P2POp(dist.irecv, got, dist.get_global_rank(group, (d + 1) % n),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def default_mesh(n_devices: int | None = None, axis: str = "v", *,
                 device="cuda") -> DeviceMesh:
    """1-D mesh named `axis` over every rank of the default process group,
    started by `_ensure_group` if there is none (torchrun's env:// variables
    when set, else a one-rank group on the caller's device). JAX's mesh
    takes the first n_devices devices; a mesh here spans the whole group,
    so n_devices, when given, must equal the world size."""
    _ensure_group(device)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh spans every rank: n_devices {n_devices} "
                         f"!= world size {world}")
    return init_device_mesh(torch.device(device).type, (world,),
                            mesh_dim_names=(axis,))


def pad_voice_axis(schedule: NoteSchedule, multiple: int) -> NoteSchedule:
    """Pad schedule rows so the voice axis divides the mesh size."""
    rows = round_up(schedule.n_rows, multiple)
    if rows == schedule.n_rows:
        return schedule
    pad = rows - schedule.n_rows

    def ext(a, fill):
        return np.concatenate([a, np.full(pad, fill, dtype=a.dtype)])

    return NoteSchedule(
        ext(schedule.press, NEVER), ext(schedule.release, NEVER),
        ext(schedule.frequency, 1.0), ext(schedule.velocity, 0.0),
        ext(schedule.pan, 0.0), ext(schedule.phase, 0.0), schedule.n_notes,
    )


def _voice_rows(tables, n: int, r: int):
    """Rank r's contiguous rows of each (V, ·) table (JAX's P(axis))."""
    V = tables[0].shape[0]
    if V % n:
        raise ValueError(f"{V} voice rows do not split over {n} ranks "
                         "(pad_voice_axis pads a schedule)")
    per = V // n
    return tuple(t[r * per:(r + 1) * per] for t in tables)


def make_sharded_renderer(mesh: DeviceMesh, *, dtype: str, device="cuda",
                          **statics):
    """Voice-bank renderer with the voice axis sharded over the mesh's
    first axis: fn(fp, ip, up, gains, codes), called on every rank with the
    whole tables of voicebank.prepare_bank_arrays, renders the rank's rows
    (one kernel launch on the card, the plain version on the CPU) and
    returns the all-reduced (n_blocks, block_size, C) output."""
    dev = _mesh_device(mesh, device)
    group = mesh.get_group(0)
    n, r = mesh.size(), mesh.get_local_rank(0)
    want = {"float32": torch.float32, "float64": torch.float64}[dtype]

    def fn(*tables):
        if tables[0].dtype != want or tables[0].device != dev:
            raise ValueError(f"tables are {tables[0].dtype} on {tables[0].device}, "
                             f"the renderer takes {dtype} on {dev}")
        partial = voicebank.voicebank_blocks_impl(*_voice_rows(tables, n, r),
                                                  **statics)
        return _all_reduce(partial, group)

    return fn


def render_bank_sharded(bank: voicebank.VoiceBank, n_samples: int, *,
                        block_size: int = 32768, dtype: str = "float32",
                        mesh: DeviceMesh | None = None,
                        device="cuda") -> torch.Tensor:
    """Multi-rank version of voicebank.render_bank: the (n_samples, C)
    tensor on the rank's device, on every rank."""
    if mesh is None:
        mesh = default_mesh(device=device)
    dev = _mesh_device(mesh, device)
    args, statics = voicebank.prepare_bank_arrays(bank, n_samples, block_size,
                                                  dtype, device=dev)
    out = make_sharded_renderer(mesh, dtype=dtype, device=dev, **statics)(*args)
    return out.reshape(-1, out.shape[-1])[:n_samples]


def _frames_sqmag(signal, window, *, start: int, count: int, per: int,
                  stride: int, fft_len: int):
    """ops/stft._stft_sqmag of `count` frames from sample `start`, zero rows
    padding them to `per` (padded frames are cut after the gather)."""
    ws = int(window.shape[0])
    seg = signal[start:start + (count - 1) * stride + ws] if count else signal[:0]
    sq = stft_ops._stft_sqmag(seg, window, window_size=ws, stride=stride,
                              fft_length=fft_len)
    return torch.nn.functional.pad(sq, (0, 0, 0, per - count))


def _local_sqmag(signal, window, *, n_frames, n_dev, me, stride, fft_len):
    """The squared magnitudes of rank `me`'s frames when the frames are
    padded to a multiple of n_dev and split in rank order (JAX's frame
    starts in P(axis))."""
    per = -(-n_frames // n_dev)
    count = max(0, min(per, n_frames - me * per))
    return _frames_sqmag(signal, window, start=me * per * stride, count=count,
                         per=per, stride=stride, fft_len=fft_len)


def _signal_and_window(signal, window, dev):
    sig = signal.to(dev) if torch.is_tensor(signal) else torch.as_tensor(
        np.asarray(signal), device=dev)
    return sig, torch.as_tensor(np.asarray(window), dtype=sig.dtype, device=dev)


def stft_sqmag_sharded(signal, window, stride: int,
                       mesh: DeviceMesh | None = None,
                       fft_length: int | None = None, *, device="cuda"):
    """Frame-axis-sharded STFT: every rank holds the signal and FFTs its
    share of the analysis frames (the reference's analysis thread becomes a
    mesh dimension); an all_gather assembles them. Returns the
    (n_frames, n_bins) squared magnitudes on every rank."""
    if mesh is None:
        mesh = default_mesh(device=device)
    dev = _mesh_device(mesh, device)
    sig, win = _signal_and_window(signal, window, dev)
    ws = int(win.shape[0])
    fft_len = stft_ops.fft_length_for(ws) if fft_length is None else fft_length
    n_frames = max(0, (sig.shape[0] - ws) // stride + 1)
    sq = _local_sqmag(sig, win, n_frames=n_frames, n_dev=mesh.size(),
                      me=mesh.get_local_rank(0), stride=stride, fft_len=fft_len)
    return _all_gather(sq, mesh.get_group(0))[:n_frames]


def stft_sqmag_sharded_halo(signal, window, stride: int,
                            mesh: DeviceMesh | None = None,
                            fft_length: int | None = None, *, device="cuda"):
    """Sequence-parallel STFT where the SIGNAL ITSELF is time-sharded: each
    rank moves only its contiguous chunk of ceil(n / n_dev) samples to its
    device and FFTs the frames that start inside it; windows straddling the
    chunk's end read a one-window halo sent by the next rank. Per-rank memory
    and traffic are O(n/n_dev + ws), the layout for signals too long for one
    card's memory.

    Per-shard frame counts differ by at most one, so every rank computes a
    fixed capacity of frames, and an index map built on the host reassembles
    the global frame order after the all_gather. Returns (n_frames, n_bins).
    """
    if mesh is None:
        mesh = default_mesh(device=device)
    dev = _mesh_device(mesh, device)
    group = mesh.get_group(0)
    n_dev, me = mesh.size(), mesh.get_local_rank(0)
    full = signal if torch.is_tensor(signal) else np.asarray(signal)
    ws = int(np.asarray(window).shape[0])
    fft_len = stft_ops.fft_length_for(ws) if fft_length is None else fft_length
    n = int(full.shape[0])
    n_frames = max(0, (n - ws) // stride + 1)
    Ls = -(-n // n_dev)  # samples per shard
    if ws > Ls:
        raise ValueError(f"a {ws}-sample window spans more than one shard of "
                         f"{Ls} samples: use fewer ranks or stft_sqmag_sharded")

    # host-side frame -> (shard, local slot) assignment
    g_starts = np.arange(n_frames) * stride
    shard_of = np.minimum(g_starts // Ls, n_dev - 1)
    counts = np.bincount(shard_of, minlength=n_dev)
    Flc = max(1, int(counts.max()))
    flat_index = np.zeros(n_frames, np.int64)
    for d in range(n_dev):
        gs = np.nonzero(shard_of == d)[0]
        flat_index[gs] = d * Flc + np.arange(len(gs))
    mine = np.nonzero(shard_of == me)[0]
    start = int(g_starts[mine[0]]) - me * Ls if len(mine) else 0

    # this rank's chunk, zero-padded past the signal's end; the last
    # shard's frames end inside it (start + ws <= n), so the wrap from
    # shard 0 is never read
    chunk = full[me * Ls:min(n, (me + 1) * Ls)]
    sig, win = _signal_and_window(chunk, window, dev)
    shard = torch.nn.functional.pad(sig, (0, Ls - sig.shape[0]))
    ext = torch.cat([shard, _ring_from_next(shard[:ws], group)])
    sq = _frames_sqmag(ext, win, start=start, count=len(mine), per=Flc,
                       stride=stride, fft_len=fft_len)
    return _all_gather(sq, group)[torch.as_tensor(flat_index, device=dev)]


def render_schedule_sharded(schedule: NoteSchedule, n_samples: int,
                            config: sine_synth.SineSynthConfig,
                            mesh: DeviceMesh | None = None, *,
                            device="cuda") -> torch.Tensor:
    """Multi-rank version of models.sine_synth.render_schedule."""
    if mesh is None:
        mesh = default_mesh(device=device)
    schedule = pad_voice_axis(schedule, mesh.size())
    bank = sine_synth.bank_from_schedule(schedule, config)
    return render_bank_sharded(bank, n_samples, block_size=config.block_size,
                               dtype=config.dtype, mesh=mesh, device=device)


@dataclass
class _Job:
    """One job's tensors on a rank's device."""
    bank_args: tuple      # dense voice-bank tables (fp, ip, up, gains, codes)
    av_args: tuple        # (window, carrier, band matrix, modulator rows)
    av_kw: dict           # the analysis and vocoder keywords, block_size, n_blocks
    tracker_args: tuple   # loudness pitches and SPL, pan and phase pools
    tr_kw: dict           # build_tables_device's keywords


_VOC_KEYS = ("sample_rate", "mod_window", "voc_stride", "car_fft",
             "n_mod_frames", "vol_mod", "vol_car", "vol_voc", "edges",
             "mod_shape")


class _ChainSetup:
    """What every sharded chain shares: the render's frame count padded for
    the ranks, the staging of one job's tensors (that of the single-device
    chain, chain.prepare_offline_chain_device) and the chain's stages, each
    over a given process group. The float32 chain, as JAX's sharded chains."""

    def __init__(self, rconfig, vparams, n_samples: int, *, total_pad: int):
        if rconfig.dtype != "float32":
            raise ValueError(f"the sharded chains are float32, got {rconfig.dtype!r}")
        self.rconfig, self.vparams, self.n = rconfig, vparams, n_samples
        self.n_frames = chain_mod._n_frames(n_samples, rconfig)
        # the render's frames, padded so every rank gets equal rows (the
        # single-device chain renders n_frames + 8)
        self.total_frames = round_up(self.n_frames + 8, total_pad)
        self.rcfg = resynth_mod._render_config(rconfig)
        self.k = rconfig.max_voices + 1
        S = vparams.stride
        self.stereo_len = self.rcfg.start_sample + self.total_frames * self.rcfg.stride
        self.voc_len = max(0, (n_samples - 2 * S) // S + 1) * S

    def tracker_inputs(self, dev):
        """(tracker tensors, keywords) on `dev`."""
        args, kw = chain_mod._tracker_inputs(self.rconfig, self.rcfg,
                                             self.n_frames, None, torch.float32, dev)
        return args, dict(kw, total_frames=self.total_frames)

    def stage(self, bank, carrier, block_size: int, dev) -> _Job:
        """One job's tensors on `dev`."""
        bank_args, av_args, av_kw = chain_mod._stage_analyze_vocode(
            bank, self.n, self.rconfig, self.vparams, carrier, block_size, dev)
        return _Job(bank_args, av_args, av_kw, *self.tracker_inputs(dev))

    def mono(self, job: _Job, group, n_dev: int, me: int) -> torch.Tensor:
        """Voice-sharded synth -> mono bus, all-reduced over `group`."""
        out = voicebank.voicebank_blocks_impl(
            *_voice_rows(job.bank_args, n_dev, me),
            block_size=job.av_kw["block_size"], n_blocks=job.av_kw["n_blocks"])
        return _all_reduce(out.reshape(-1, out.shape[-1])[:self.n].sum(dim=1),
                           group)

    def peaks(self, mono, job: _Job, group, n_dev: int, me: int):
        """Frame-sharded STFT and top-k peaks, gathered: (freq, mag_db)."""
        kw = job.av_kw
        sq = _local_sqmag(mono, job.av_args[0], n_frames=self.n_frames,
                          n_dev=n_dev, me=me, stride=kw["stride"],
                          fft_len=kw["fft_len"])
        freq, mag = stft_ops._top_peaks(sq, sample_rate=kw["sample_rate"],
                                        fft_length=kw["fft_len"], k=self.k)
        both = _all_gather(torch.stack([freq, mag], dim=-1), group)[:self.n_frames]
        return both[..., 0].contiguous(), both[..., 1].contiguous()

    def track(self, freq, mag, tracker_args, tr_kw):
        """The replicated device tracker: ((total_frames, P, 16), dropped)."""
        return device_tracker.build_tables_device(freq, mag, *tracker_args,
                                                  device=freq.device, **tr_kw)

    def render(self, table, group, n_dev: int, me: int) -> torch.Tensor:
        """Frame-sharded tracked-note render of the rank's table rows,
        gathered and padded to (start_sample + total_frames*stride, 2)."""
        Fl = self.total_frames // n_dev
        rows = resynth_bank._render_slots(table[me * Fl:(me + 1) * Fl],
                                          stride=self.rcfg.stride, dtype="float32")
        return chain_mod.assemble_framed_stereo(_all_gather(rows, group),
                                                self.rcfg.start_sample)

    def vocode(self, mono, job: _Job) -> torch.Tensor:
        """The replicated vocoder mix of the mono bus (chain._vocode_mix)."""
        _window, car, bm_car, rows = job.av_args
        return chain_mod._vocode_mix(mono, car, bm_car, rows,
                                     **{k: job.av_kw[k] for k in _VOC_KEYS})


def _counted(run):
    """step() around run(): step.collective_counts() gives the collectives,
    by kind, of the last step() call."""
    last = {}

    def step():
        before = dict(COUNTS)
        out = run()
        last.clear()
        last.update({k: COUNTS[k] - before[k] for k in COUNTS})
        return out

    def collective_counts() -> dict:
        if not last:
            raise RuntimeError("collective_counts() reads the last step(): run one first")
        return dict(last)

    step.collective_counts = collective_counts
    return step


def _sharded_chain(mesh: DeviceMesh, n_samples: int, rconfig, vparams, *,
                   block_size: int, axis: str, device):
    dev = _mesh_device(mesh, device)
    group = mesh.get_group(axis)
    n_dev, me = dist.get_world_size(group), mesh.get_local_rank(axis)
    cs = _ChainSetup(rconfig, vparams, n_samples, total_pad=n_dev)

    def build(bank, carrier):
        job = cs.stage(bank, carrier, block_size, dev)

        def run():
            mono = cs.mono(job, group, n_dev, me)
            freq, mag = cs.peaks(mono, job, group, n_dev, me)
            table, dropped = cs.track(freq, mag, job.tracker_args, job.tr_kw)
            return cs.render(table, group, n_dev, me), cs.vocode(mono, job), dropped

        return _counted(run)

    return build, cs


def make_sharded_chain(mesh: DeviceMesh, n_samples: int, rconfig, vparams,
                       *, block_size: int = 1 << 15, axis: str = "v",
                       device="cuda"):
    """The FULL offline chain (synth -> STFT/peaks -> tracker -> tracked
    render + vocoder), sharded over the mesh axis `axis`:

      * synth: voice-axis data parallel, the mono mixdown an all_reduce
        (the reference's "+= voice" bus, gen.crtp.h:350-378);
      * STFT + peak extraction: frame-axis parallel (analysis frames are
        independent), the (frames, k) peaks all_gathered;
      * pitch tracker: replicated (control-sized work);
      * tracked-note render: frame-axis parallel again (table rows are
        self-contained per frame), the output all_gathered;
      * vocoder: replicated.

    Returns build(bank, carrier) -> step; step() returns (stereo, vocoded,
    dropped) on every rank, and step.collective_counts() the collectives of
    the last step() by kind. The tracker's frames are padded to a multiple
    of the world size, so stereo runs (start_sample + total_frames*stride)
    samples. Only the no-autotune/no-harmonize float32 config subset, as
    JAX's (the single-device chain.run_offline_chain_device covers the
    rest). Every rank runs the tracker on the same gathered peaks; its
    float sums have an order fixed by the shapes, so every rank builds the
    same table, to the bit.
    """
    build, _cs = _sharded_chain(mesh, n_samples, rconfig, vparams,
                                block_size=block_size, axis=axis, device=device)
    return build


def default_mesh_2d(nv: int, nf: int, *, device="cuda") -> DeviceMesh:
    """2-D ('v', 'f') mesh: voice-data-parallel x time/frame-sequence-
    parallel, over every rank (nv * nf must be the world size; the default
    process group is started as in default_mesh)."""
    _ensure_group(device)
    world = dist.get_world_size()
    if nv * nf != world:
        raise ValueError(f"a ({nv}, {nf}) mesh needs {nv * nf} ranks, the world has {world}")
    return init_device_mesh(torch.device(device).type, (nv, nf),
                            mesh_dim_names=("v", "f"))


def make_sharded_chain_2d(mesh: DeviceMesh, n_samples: int, rconfig, vparams,
                          *, block_size: int = 1 << 15, device="cuda"):
    """The full offline chain over a 2-D ('v', 'f') mesh: the tensor axes
    map to DIFFERENT mesh axes per stage:

      * synth: voices sharded over 'v' AND render blocks over 'f' (each
        (v, f) rank renders its voice slice of its time slice through the
        kernel's block_offset); the mono bus is an all_reduce over 'v',
        then an all_gather of the time shards over 'f' (analysis windows
        straddle time-shard boundaries);
      * STFT/peaks and the tracked-note render: frames sharded over the
        FLATTENED ('v', 'f') product, rank v*nf + f;
      * tracker and vocoder: replicated.

    Same config subset and results as make_sharded_chain. Voice rows must
    divide the 'v' axis size; the mesh spans every rank in rank order
    (default_mesh_2d).
    """
    if tuple(mesh.mesh_dim_names or ()) != ("v", "f"):
        raise ValueError(f"expected a ('v', 'f') mesh, got {mesh.mesh_dim_names}")
    dev = _mesh_device(mesh, device)
    nv, nf = mesh.shape
    n_dev = nv * nf
    if mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise ValueError("the 2-D chain's mesh must hold every rank in rank order")
    gv, gf = mesh.get_group("v"), mesh.get_group("f")
    v, f = mesh.get_local_rank("v"), mesh.get_local_rank("f")
    me = v * nf + f  # the rank's index in the flattened product: its global rank
    cs = _ChainSetup(rconfig, vparams, n_samples, total_pad=n_dev)

    def build(bank, carrier):
        job = cs.stage(bank, carrier, block_size, dev)
        B = job.av_kw["block_size"]
        nb_local = -(-job.av_kw["n_blocks"] // nf)
        Ls = nb_local * B
        tail = (f * Ls + torch.arange(Ls, device=dev)) >= n_samples

        def run():
            # 1. (voice slice x time slice) synth: the all_reduce over 'v'
            # builds the mono bus of the time shard, the all_gather over
            # 'f' the signal
            out = voicebank.voicebank_blocks_impl(
                *_voice_rows(job.bank_args, nv, v), block_size=B, n_blocks=nb_local,
                block_offset=f * nb_local)
            mono_local = _all_reduce(out.reshape(Ls, -1).sum(dim=1), gv)
            mono_local = mono_local.masked_fill(tail, 0.0)
            mono = _all_gather(mono_local, gf)[:n_samples]
            # 2.-5. over the flattened product (the world group)
            freq, mag = cs.peaks(mono, job, None, n_dev, me)
            table, dropped = cs.track(freq, mag, job.tracker_args, job.tr_kw)
            return cs.render(table, None, n_dev, me), cs.vocode(mono, job), dropped

        return _counted(run)

    return build


def _in_mesh(mesh: DeviceMesh) -> bool:
    return mesh.get_coordinate() is not None


def _pipelined_chain(mesh_a: DeviceMesh, mesh_b: DeviceMesh, n_samples: int,
                     rconfig, vparams, *, block_size: int, device):
    dev_a, dev_b = _mesh_device(mesh_a, device), _mesh_device(mesh_b, device)
    ranks_a = mesh_a.mesh.flatten().tolist()
    ranks_b = mesh_b.mesh.flatten().tolist()
    if set(ranks_a) & set(ranks_b) or not ranks_a or not ranks_b:
        raise ValueError(f"the stages need disjoint ranks: {ranks_a} and {ranks_b}")
    na, nb_dev = len(ranks_a), len(ranks_b)
    a0 = ranks_a[0]
    cs = _ChainSetup(rconfig, vparams, n_samples, total_pad=nb_dev)
    # every rank takes part in making the hand-off group
    handoff = dist.new_group([a0, *ranks_b])
    rank = dist.get_rank()
    in_a, in_b = _in_mesh(mesh_a), _in_mesh(mesh_b)
    tracker_args, tr_kw = cs.tracker_inputs(dev_b) if in_b else (None, None)

    def stage1(bank, carrier):
        if not in_a:
            return None
        group, me = mesh_a.get_group(0), mesh_a.get_local_rank(0)
        job = cs.stage(bank, carrier, block_size, dev_a)
        mono = cs.mono(job, group, na, me)
        freq, mag = cs.peaks(mono, job, group, na, me)
        return freq, mag, cs.vocode(mono, job)

    def stage2(freq, mag):
        if rank != a0 and not in_b:
            return None
        if rank == a0:
            both = torch.stack([freq, mag])
        else:
            both = torch.empty((2, cs.n_frames, cs.k), dtype=torch.float32,
                               device=dev_b)
        _broadcast(both, a0, handoff)
        if not in_b:
            return None
        table, dropped = cs.track(both[0], both[1], tracker_args, tr_kw)
        return (cs.render(table, mesh_b.get_group(0), nb_dev,
                          mesh_b.get_local_rank(0)), dropped)

    return stage1, stage2, cs


def make_pipelined_chain(mesh_a: DeviceMesh, mesh_b: DeviceMesh,
                         n_samples: int, rconfig, vparams, *,
                         block_size: int = 1 << 15, device="cuda"):
    """Pipeline parallelism across jobs: stage 1 (voice-DP synth ->
    frame-SP STFT/peaks -> vocoder) runs on the ranks of `mesh_a` while
    stage 2 (replicated tracker -> frame-SP tracked render) of the PREVIOUS
    job runs on those of `mesh_b`. The cut is the peak lists: a small
    (2, frames, k) broadcast from mesh_a's first rank to mesh_b per job
    (the reference's analysis-thread -> synth handoff,
    rt.resynth.lib.cpp:1670-1759, as a device-group boundary).

    Both meshes are 1-D DeviceMeshes over disjoint ranks, made on every
    rank; every rank calls both stages. Returns (stage1, stage2):
    stage1(bank, carrier) -> (freq, mag, vocoded) on mesh_a's ranks, None
    elsewhere; stage2(freq, mag) -> (stereo, dropped) on mesh_b's ranks,
    None elsewhere (freq and mag are read on mesh_a's first rank only). The
    groups are separate processes, so they overlap by themselves: drive
    them with render_jobs_pipelined.
    """
    stage1, stage2, _cs = _pipelined_chain(mesh_a, mesh_b, n_samples, rconfig,
                                           vparams, block_size=block_size,
                                           device=device)
    return stage1, stage2


def _result_buffers(cs: _ChainSetup, dev):
    return (torch.empty((cs.stereo_len, 2), dtype=torch.float32, device=dev),
            torch.empty((cs.voc_len,), dtype=torch.float32, device=dev),
            torch.empty((1,), dtype=torch.int64, device=dev))


def render_jobs_pipelined(banks, n_samples: int, rconfig, vparams, carriers,
                          *, block_size: int = 1 << 15, device="cuda"):
    """Two-stage pipeline over the world: the first half of the ranks runs
    stage 1 (synth/analysis/vocoder) of job k while the second half runs
    stage 2 (tracker/render) of job k-1; only the peak lists cross the group
    boundary. (With an odd world the last rank idles in the stages.)

    Returns, on every rank, a list of (stereo, vocoded, dropped) per job in
    job order: each output reaches the other ranks by one broadcast from
    the group that made it, after the last job (JAX's fetch of each job's
    results from the devices that rendered them). Needs two ranks at least:
    one rank cannot hold both stages.
    """
    dev = _rank_device(device)
    _ensure_group(dev)
    world = dist.get_world_size()
    if world < 2:
        raise ValueError("the pipelined chain needs two ranks at least, one per stage")
    half = world // 2
    mesh_a = DeviceMesh(dev.type, list(range(half)), mesh_dim_names=("v",))
    mesh_b = DeviceMesh(dev.type, list(range(half, 2 * half)),
                        mesh_dim_names=("f",))
    stage1, stage2, cs = _pipelined_chain(mesh_a, mesh_b, n_samples, rconfig,
                                          vparams, block_size=block_size,
                                          device=dev)
    made = []
    for bank, carrier in zip(banks, carriers):
        s1 = stage1(bank, carrier)
        freq, mag, voc = s1 if s1 is not None else (None, None, None)
        made.append((voc, stage2(freq, mag)))
    outs = []
    for voc, s2 in made:
        stereo_buf, voc_buf, dropped_buf = _result_buffers(cs, dev)
        if s2 is not None:
            stereo_buf, dropped_buf = s2[0], s2[1].reshape(1).to(torch.int64)
        if voc is not None:
            voc_buf = voc
        _broadcast(voc_buf, 0, None)
        _broadcast(stereo_buf, half, None)
        _broadcast(dropped_buf, half, None)
        outs.append((stereo_buf, voc_buf, dropped_buf[0]))
    return outs


def render_jobs_farm(banks, n_samples: int, rconfig, vparams, carriers,
                     *, n_groups: int = 2, block_size: int = 1 << 15,
                     device="cuda"):
    """Job-level parallelism (the 'farm-style batch rendering' analog,
    SURVEY §2.9/§5.8): split the world into `n_groups` equal groups (a
    ('g', 'v') mesh), build the voice-sharded chain once per group over its
    'v' axis, and give job j to group j mod n_groups. Independent jobs need
    no collective across groups until the results: each job's outputs
    reach every rank by one broadcast from its group's first rank.

    Returns, on every rank, a list of (stereo, vocoded, dropped) per job in
    job order.
    """
    dev = _rank_device(device)
    _ensure_group(dev)
    world = dist.get_world_size()
    per = world // n_groups
    if per < 1:
        raise ValueError(f"{world} ranks cannot form {n_groups} groups")
    if per * n_groups != world:
        raise ValueError(f"{world} ranks do not split into {n_groups} equal groups")
    mesh = init_device_mesh(dev.type, (n_groups, per), mesh_dim_names=("g", "v"))
    g = mesh.get_local_rank("g")
    build, cs = _sharded_chain(mesh["v"], n_samples, rconfig, vparams,
                               block_size=block_size, axis="v", device=dev)
    mine = {j: build(bank, carrier)()
            for j, (bank, carrier) in enumerate(zip(banks, carriers))
            if j % n_groups == g}
    outs = []
    for j in range(len(banks)):
        src = int(mesh.mesh[j % n_groups, 0])
        if j in mine:
            stereo, voc, dropped = mine[j]
            bufs = (stereo, voc, dropped.reshape(1).to(torch.int64))
        else:
            bufs = _result_buffers(cs, dev)
        for b in bufs:
            _broadcast(b, src, None)
        outs.append((bufs[0], bufs[1], bufs[2][0]))
    return outs
