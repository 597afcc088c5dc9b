#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``sheeprl_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. device   — the card's name and power limit; CUDA must be present.
2. build    — nvcc builds every kernel of the serving path from ``csrc/``.
3. kernels  — each kernel against its plain PyTorch version in fp32 (TF32
              off) at the DreamerV3 S/M/L/XL widths, B in {1, 7, 8, 16, 32,
              128, 1024} (every serving rung, the training batches and every
              row tile of the GEMM) and leading dims (2, 3), Z+A in {1028
              (served), 1030}; max abs error on h' <= 1e-4.  At XL and B in
              {1, 8, 16, 32, 128, 1024}: kernel, plain version, the products
              alone in cuBLAS fp32 (a partial yardstick the port never
              calls), the bound and the device time of each launch.
4. serve    — DreamerV3-XL (random weights from the seed, fused RSSM kernel)
              written as a committed snapshot, loaded by
              ``PolicyService.from_checkpoint`` and served by ``PolicyServer``
              to 16 concurrent sessions x 8 steps over HTTP; the rssm launch
              count is read around this run.
5. parity   — one served step, at the rung dispatched most, against the
              same step with the plain RSSM.
6. gru path — the same width with only the GRU cell fused (``use_pallas``),
              one session x 8 steps; the gru launch count is read around it.
7. train    — DreamerV3-XL training through ``sheeprl_tpu_torch.cli.run``
              (fused RSSM kernel, rgb + state, batch 16 x sequence 64,
              horizon 15, player on the card, CSV logger): a prefill of one
              sequence, then 10 updates; updates/s, the first update's
              seconds, peak device memory, kernel launches per update (64
              posterior + 16 imagination steps = 80), the ten metrics finite,
              and a ``torch.profiler`` top-10 of one update's device time.
8. train parity — one XL update from the trained snapshot, the same data
              and noise, with the fused kernel and with the plain RSSM: the
              ten losses, the world-model gradient norm and the posterior
              latents agree within the stated tolerance, and three faulty
              plain versions (the LayerNorm eps swapped, the reset and update
              gates swapped, the products in one pass of TF32) are caught by
              the same tolerance.
9. serve trained — the snapshot of phase 7 loaded by ``load_policy``, one
              served step, a valid action.
10. train gru — DreamerV3-S training with only the GRU cell fused
              (``use_pallas``), 3 updates; the gru launches per update.
11. p2e explore — Plan2Explore-DreamerV3 exploration at XL through
              ``cli.run`` (``exp=p2e_dv3_exploration``, the phase-7 recipe,
              fused RSSM kernel), 2 updates: 96 rssm launches per update (64
              posterior steps + two imagination rollouts of 16), no gru
              launch; the ten metrics and the intrinsic reward finite.
12. p2e parity — one XL exploration update from phase 11's snapshot, fused
              kernel against the plain RSSM and the three faulty plain
              versions, on phase 8's limits.
13. p2e finetune — ``exp=p2e_dv3_finetuning`` from phase 11's snapshot, 2
              updates of 80 rssm launches; the finetuning actor at load is
              phase 11's task actor bit for bit; the snapshot evaluated
              once through ``cli.evaluation``.
14. decoupled — DreamerV3-XL with ``decoupled_rssm`` and the fused kernel,
              2 updates of 80 rssm launches.
15. family  — DreamerV2, Plan2Explore-DV2, DreamerV1 and Plan2Explore-DV1
              at their default widths (rgb + state; two of them on the
              ``EpisodeBuffer``), 2 updates each, metrics finite and the
              P2E runs' intrinsic reward finite in every update, no kernel
              launch (their models take no kernel flag).
16. ppo train — PPO at its Atari widths (``exp=ppo_atari``: CNN 32/64/64
              on 84x84 rgb frame-stacked 4 times, dense 512, rollout 1024,
              batch 256, 3 epochs) on the dummy env through ``cli.run``, 2
              iterations (2048 env steps, 24 minibatch steps): iterations/s,
              env steps/s, the first iteration's seconds, peak device
              memory, the losses finite, no kernel launch; a
              ``torch.profiler`` top-10 of one update by kind, with the
              device's idle share.
17. ppo parity — one PPO train phase at those widths on the card against
              the same phase on the CPU in this process (same weights,
              rollout and minibatch orders, TF32 off): parameters and losses
              within the stated tolerance; the SAME pad put on the wrong side
              of the odd stage is caught by it.
18. ppo serve — phase 16's snapshot loaded by ``PolicyService.from_checkpoint``
              and served over HTTP to 16 sessions x 8 steps, greedy and
              sampled rows mixed: actions/s, client and service p50/p99,
              every action valid, no kernel launch.
19. a2c / ppo_recurrent — A2C at its Atari widths (2 iterations of 40
              steps, ``rmsprop``, then ``rmsprop_tf``) and recurrent PPO at
              its defaults on the vector observation (2 iterations of 2
              epochs): metrics
              finite, no kernel launch, each snapshot evaluated once through
              ``cli.evaluation``.

20. sac train — SAC at its recipe's widths (``exp=sac``: hidden 256 x 2, two
              critics, batch 256, replay ratio 1) on the continuous dummy
              env's 4-wide ``state`` through ``cli.run``: a prefill of 100
              random steps, then 400 updates (the first window repays the
              prefill); updates/s, env steps/s, the first update's seconds,
              peak device memory, a ``torch.profiler`` top-10 of one update
              with its launches and the device's busy share, no kernel
              launch; the snapshot evaluated through ``cli.evaluation``.
21. droq train — DroQ the same at replay ratio 20 and dropout 0.01 (masks
              drawn on the card): a prefill of 20 steps, then 600 updates.
22. sac_ae train — SAC-AE on the 64x64 ``rgb`` (``exp=sac_ae``: encoder
              16/32/64 to 64 features, actor and critics at 1024, decoder
              64/32/16 → 3, batch 128; the actor and targets every 2
              updates, the decoder every update): the recipe's 1,000-step
              prefill cut to 128, then 178 updates.
23. off-policy parity — one SAC train phase (U 8, batch 256) and one SAC-AE
              train phase (U 4, batch 128) from phases 20 and 22's snapshots
              on the card and on the CPU in this process (same weights,
              batches and noise, SGD for every group, TF32 off): parameters
              and losses within phase 17's tolerance; SAC-AE with the
              decoder's deconv kernels left unflipped, and SAC with the actor
              step reading the critic before its update, are caught by it;
              TF32 on and the recipe's Adam reported.
24. sac serve — phase 20's snapshot served by ``PolicyServer`` over HTTP to
              16 sessions x 8 steps, greedy and sampled rows mixed:
              actions/s, client and service p50/p99, every action inside
              the bounds, no kernel launch.

25. env parity — each device env (cartpole, pendulum, forage, multiroom)
              stepped 256 steps x 64 envs on the card and on the CPU from
              the same state, actions and reset draws, teacher-forced from
              the CPU state at every step: integers, flags and uint8 frames
              equal, the largest float difference printed and held to 1e-4.
26. anakin ppo — PPO's recipe (``exp=ppo env=jax_cartpole``) on the Anakin
              rollout at 1024 envs, batch 16384 (8 minibatches x 10
              epochs), 3 iterations: env steps/s, the rollout's ms per step,
              launches per rollout step and the device's busy share in it
              (a profiled rollout), peak memory; every rollout runs under
              ``torch.cuda.set_sync_debug_mode("error")``.
              Beside it the adapter path (``algo.anakin=False``) at 16 envs.
27. anakin family — PPO through the CNN on ``jax_forage`` at 128 envs,
              A2C on ``jax_cartpole`` under both RMSprops and recurrent PPO,
              2 iterations each under the same gate.
28. dv3 forage — phase 7's XL recipe on ``jax_forage`` through the adapter
              (``rgb`` alone, fused RSSM kernel), 4 updates: 80 rssm
              launches per update, one update held to the plain RSSM at
              phase 8's limits.
29. ppo atari forage — ``exp=ppo_atari`` on forage at Atari's input (84x84,
              gray, 4 frames): the CNN sees 4 channels; env steps/s.
30. sac pendulum — SAC's recipe on ``jax_pendulum`` through the adapter.

``buffer.device=auto`` puts the replay ring on the card, so phases
11-15, 28 and 30 train from it; phases 7 and 20-22 pin the host ring
(``buffer.device=False``), the baselines of phases 32 and 34.

31. replay ring — a ring on the card and one on the CPU fed the same adds
              (3 envs, a window of 16, 23 steps, subset rows, a
              ``repair_tail``, wrapping): contents, cursors, uniform batches
              (with ``derive_next``) and sequence blocks at the same draws,
              and the ring's and the spill tier's checkpoint round trips
              equal bit for bit.
32. replay xl — phase 7's XL recipe with ``buffer.size=250000`` (the
              recipe's million cut by 4), ``buffer.transfer_guard=True`` and
              a 2 GiB budget, so the window shrinks and the spill (memmapped in the
              run directory, deleted after) is armed: the window, the ring's
              bytes on the card, updates/s beside phase 7's from this run,
              first-update seconds, peak memory, 80 rssm launches in every
              update, every window after the first under ``steady_guard``.
33. replay parity — one XL window at the same indices from a card ring and
              a host ring holding the same adds: the blocks equal bit for
              bit, one update on each gives the same ten losses.
34. replay off-policy — SAC, DroQ and SAC-AE on the card's ring at phases
              20-22's widths, the guard armed: updates/s beside phases
              20-22's, launches per update and busy share of one update.
35. replay resume — SAC under a budget that arms the spill, and a small
              DreamerV3, checkpointed and resumed: the ring a resume loads
              equals the one saved, and training continues.
36. replay guard — inside ``steady_guard(True)`` a blocking copy from the
              host (``torch.tensor(x, device=...)``, a pageable ``.to``) and
              a read back raise; explicit staging does not.

Every route of the loops goes through ``fabric.compile`` (``parallel/compile.py``):
the DreamerV3 window (phases 7, 10, 13, 14, 28, 32: chunks of up to 4
updates, one captured CUDA graph per chunk size, each replay credited with
the kernel launches its capture recorded), the DreamerV3 player, the served
DreamerV3 step (phases 4, 6, 9) and PPO's Anakin rollout (phase 26) are
replayed graphs; ``_train`` times the window route per chunk.

37. graphs layer — a small function captured: replay equals eager bit for
              bit (a registered generator's draws included), one capture
              per signature, ``max_recompiles=0`` raises before a second
              capture, a function calling ``.item()`` fails to capture and
              raises, and a later capture still works.
38. graphs dv3-xl — one chunk of 4 XL updates of the fused window on the
              card's ring (RSSM kernel), from one state and generator
              state, eager twice and through ``fabric.compile`` twice (first
              call eager then captured, then replayed) under cuDNN's
              deterministic algorithms: drawn indices, the ten losses and
              every parameter equal bit for bit where the two eager runs
              are; 80 rssm launches per update credited per replay; then
              a replayed and an eager chunk in turns (graph, eager):
              updates/s, host ms and host calls per update, device
              operations and ms per update, 3 captures for chunk sizes 4, 2
              and 1, peak memory.  Its trainer, ring and captured window
              stay alive for phases 63, 51's span turns and 43, which run
              on them next: no other fp32 XL window is built or captured.
39. graphs dv3-s-gru — phase 38 for DreamerV3-S with the GRU kernel (kept
              for phase 44).
40. graphs serve — the served DreamerV3-XL step: every ladder rung captured
              at warm-up, rungs 1 and 32 equal eager bit for bit for the
              same seeds, then 16 sessions x 8 steps over HTTP in turns
              (captured, eager, eager, captured) on one server.
41. graphs anakin — Anakin PPO on ``jax_cartpole`` at 1024 envs: one
              rollout eager and replayed from one state, trajectories,
              episode statistics and the new state bit for bit; env
              steps/s in turns, host calls per rollout step, the card's
              busy share.

``fabric.precision=bf16-mixed`` (the JAX policy: bf16 compute, fp32
parameters and optimizer state, the kernels fed fp32 at their wrappers):

42. precision kernels — each kernel at XL, B in {1, 32, 1024}, on bf16 ``x``
              and ``h``: bit for bit its call on the fp32 upcasts, within
              1e-4 of its plain version; the wrapper timed beside the kernel
              on fp32 operands and the two casts alone.
43. precision dv3-xl — DreamerV3-XL (``fused_pallas``) under bf16-mixed:
              trained through ``cli.run`` as phase 7 (10 updates, 80 rssm
              launches in each, the snapshot kept for phase 46); phase 38's
              window under bf16-mixed, run right after phase 38 beside its
              kept 32-true window (replay equals eager bit for bit, one
              capture, 80 launches per update credited per replay, peak
              memory); the two trainers start from the same weights: the
              first update's ten losses from the same draws within the
              stated tier, one eager update of each by kind of device work
              (products, convolutions, the kernel, copies and casts, the
              rest; fp32's is phase 38's profile), their captured chunks of
              4 updates in turns (bf16, fp32, fp32, bf16).
44. precision dv3-s-gru — phase 43's window and turns for DreamerV3-S with the
              GRU kernel (``use_pallas``), 80 gru launches per update.
45. precision p2e — Plan2Explore-DV3-XL exploration under bf16-mixed through
              ``cli.run`` (phase 11's recipe): 96 rssm launches per update,
              updates/s beside phase 11's.
46. precision serve — phase 43's snapshot (fp32 weights, loaded unchanged)
              served under its own bf16-mixed: rungs 1 and 32 replayed equal
              eager bit for bit; 16 sessions x 8 steps over HTTP in turns
              with a 32-true server of the same snapshot.
47. precision families — PPO and A2C at their Atari widths, recurrent PPO,
              SAC, DroQ and SAC-AE at their recipes', DreamerV2 and V1 at
              their defaults (rows cut: rollouts of 64 steps, 16 for recurrent PPO, off-policy 2
              updates of 64, the Dreamers' batch 4 x sequence 16): one train
              phase under bf16-mixed on the card against the same phase on
              the CPU under bf16-mixed (same weights, inputs and draws, SGD),
              the CPU's fp32 phase beside it; the card's phase timed under
              both precisions in turns.

The runtime services a default run turns on (the health guard inside the
train window, preemption, fault plans, rollback):

48. runtime guard — phase 38's XL chunk (RSSM kernel) and 39's S chunk (GRU
              kernel) with the health guard inside the captured window,
              from one state under cuDNN's deterministic algorithms, every
              replay under ``steady_guard``: bit for bit the unguarded
              window (``health.enabled=False``); a planted
              ``update.grads nonfinite at=2`` window skipped, every trained
              tensor equal to its input; 80 launches per update; guarded and
              unguarded replays in turns and the peak of each.
49. preemption — DV3-XL through ``cli.run`` in a subprocess (fused RSSM
              kernel, captured, the card's ring cut to 4096 steps), SIGTERM
              after its first replayed window: exit 0, one committed
              snapshot that ``verify_checkpoint`` passes, the seconds from
              the signal to the commit; ``resume_from=auto`` continues its
              counters, generators and ring cursor and launches the kernel
              in its first window; a process whose preempted save's commit
              hangs (a planted ``checkpoint.commit`` hang) dies on a second
              SIGTERM and its torn step is never chosen on resume.
50. faults — a commit hang past a short ``hang_warn_s`` gives one watchdog
              stall; a ``checkpoint.write_shard corrupt`` snapshot is
              quarantined on resume; the XL server under a ``serve.http``
              raise plan answers every request (the client retries); a
              planted ``update.grads divergence`` rolls SAC back on the card
              to its committed snapshot, raises ``DivergenceError`` past the
              budget, and raises it in DreamerV3.

The telemetry subsystem and serving's hot reload a default run turns on:

51. telemetry — DV3-XL (``fused_pallas``, 6 updates) through ``cli.run`` with the default
              telemetry, ``telemetry.introspect.port=0`` and trace windows at
              dispatches 1 (the first window: a chunk run eagerly and
              captured) and 3 (a replay), one dispatch each: ``/healthz``,
              ``/metrics`` and ``/v1/phase`` scraped mid-run; each trace's
              ``sheeprl::`` kernel events equal the rssm launches credited
              while its window was open; the same run untraced, both under
              cuDNN's deterministic algorithms: every trained tensor and the
              ten losses bit for bit; spans on and off in turns around
              phase 38's captured XL chunk (run beside phase 38, while its
              window is kept) and SAC's eager update.
52. signals — phase 49's preempted child takes a SIGUSR1 as soon as its
              first replayed window is seen (while this process runs the
              phases beside it): one trace window of the live run; its SIGTERM
              commits, then ``postmortem.json`` says ``preemption``; a small
              DreamerV3 run with a planted ``checkpoint.write_shard`` raise, in
              a subprocess, dumps it with its ``crash`` event and lands the
              final flush.
53. reload  — the XL server under 16 sessions while a newer committed
              snapshot (other weights) lands: every request answered, the
              watcher finds it within ``serve.reload_poll_s``, the install
              copies into the captured step's tensors (no capture: the
              compile monitor unchanged), and the step for a fixed
              observation and seed equals a fresh service's on the new
              snapshot bit for bit; a corrupt snapshot is quarantined while
              serving goes on.

The deployment surface: the model registry, a snapshot the JAX package
wrote, the serving fleet:

54. registry — ``cli.registration`` of phase 7's DreamerV3-XL snapshot: the
              five sub-models at v1, each loaded back equal to the snapshot's
              tensors bit for bit; phase 51's untraced ``cli.run`` twin runs
              with ``model_manager.disabled=False`` and registers the same
              five; ``available_agents`` lists every ported algorithm.
55. jax snapshot — the DreamerV3 snapshot the JAX package wrote
              (``tests/fixtures/jax_dv3``, ``fused_pallas=True``) served on
              the card by ``python -m sheeprl_tpu_torch.serve``: at least one
              rssm launch per batch and no gru launch (its ``/v1/stats``),
              each recorded row's h' and, through ``load_policy``'s player,
              h', the posterior logits and the actor logits within 1e-4 of
              the JAX values recorded beside it.
56. fleet   — ``python -m sheeprl_tpu_torch.serve.fleet`` with two XL
              replicas over phase 4's run directory: 16 sessions x 8 steps
              through the router and through one server in turns; each
              replica's rssm launches per batch; a replica SIGKILLed under 16
              sessions (none dropped, the slot respawned); a session idle
              through the kill stepped alone on its slot's new process equal
              bit for bit to the step from its migrated carry here; a new
              snapshot rolled out under 16 sessions (none failed, no
              recapture, each replica equal to a fresh service bit for bit).

Population training with in-trace PBT on the Anakin axis, and the run
supervisor:

57. population — PPO's recipe for 8 members x 256 envs of ``jax_cartpole``
              through ``cli.run`` (``population.exploit_every=2``,
              ``warmup=2``, 6 updates: exploits at updates 4 and 6), every
              phase after the first under ``steady_guard``: env steps/s, the
              phase's device ms (CUDA events), captured or eager and why,
              host calls per replayed phase, device kernels in one eager
              phase (profiled); the same at 4 members, whose kernels per
              phase must be within 10% of 8's; exploits, the members'
              hyperparameter spread, ``population_summary.json`` read back;
              an A2C population of 4 (the stacked RMSprop); a PPO population
              of 4 on ``jax_multiroom`` with ``population.levels=[0,1,2,3]``,
              each member's level still pinned after autoreset.
58. population parity — one PPO population window (4 members x 256 envs x
              32 steps, the exploit gate open) on the card and on the CPU
              from the same stacked state and draws, SGD with momentum:
              parameter and momentum changes within phase 17's tolerance,
              fitness, episode counts, exploits and hyperparameters equal.
59. supervisor — a DreamerV3-S child (``use_pallas``: the GRU kernel) under
              the supervisor, a fatal ``env.step`` fault planted past a
              committed save (``SHEEPRL_FAULT_PLAN``): the crash classified
              ``transient`` from its postmortem, a restart with
              ``resume_from=auto`` to the full step count, exit 0 and two
              episodes in ``supervisor_log.jsonl``; the seconds from the
              crash to the restarted child's first update and the children's
              gru launches; then ``python -m sheeprl_tpu_torch.supervisor``
              with the same fault before any commit, so it recurs at the
              same step: the breaker opens, exit 2.
60. envs in worker processes and action masks — DreamerV3-XL
              (``fused_pallas``) through ``cli.run`` on 4 dummy envs with
              ``env.sync_env=False`` (each env in a worker process, under
              the step-deadline watchdog) and then ``True``, cuDNN
              deterministic: the two runs' trained tensors and losses equal
              bit for bit; updates/s, the vector step's median time, rssm
              launches per update; one process on the card with a context
              while the workers step (``nvidia-smi``).  Then XL with
              ``algo.actor.action_masks=True`` on a masked multi-discrete
              dummy env defined here (actions (19, 5, 7), the four MineDojo
              masks as mlp keys, drawn per step): no excluded action in 256
              player steps; the captured masked player step equals the
              eager one bit for bit.
61. the vector-env watchdog — DreamerV3-S (``use_pallas``) children of
              ``--vecenv-child`` with their env in a worker: an
              ``env.step`` hang planted once past ``learning_starts`` is
              torn down, recreated and flagged (``repair_tail``), and the
              run commits its last step; a hang at every step with
              ``env.max_vecenv_restarts=1`` exits non-zero with a
              ``postmortem.json`` of reason ``watchdog``; a SIGTERM to a
              run's whole process group (the workers ignore it) ends in a
              committed save and exit 0, no worker left.
62. resume from a JAX snapshot — the committed JAX-written fixture
              (``tests/fixtures/jax_dv3``, ``fused_pallas``) resumed by
              ``cli.run`` on the card: counters on from step 40, the RSSM
              kernel in every update; its first update from the converted
              state, card vs CPU on one replay block and the same draws,
              within ``RESUME_TOL_*``, and without the Adam state far
              outside; then ``resume_from=auto`` continues the port's own
              snapshot.
63. ``matmul_precision`` — on phase 38's XL trainer and captured window:
              the window of one update captured again under ``high``
              (TF32 in cuBLAS and cuDNN) beside phase 38's ``highest``
              one; device ms per update by kind for each, the two
              replayed in turns from one state (3 each), the ten losses of
              the same update, the RSSM kernel's output bit for bit under
              both settings, 80 rssm launches per update under each; under
              ``high`` the products and the convolutions each take at most
              ``MATMUL_TF32_SHARE`` of their fp32 device ms.
64. resume a JAX population — the committed JAX-written PPO population
              (``tests/fixtures/jax_ppo_population``, P = 4, Adam) resumed
              by ``cli.run`` on the card for two population phases, its
              counters, exploits and episodes going on; its first phase
              from the converted state, card vs CPU on the same draws,
              within ``POP_RESUME_TOL``, and without the optimizer state at
              least ``POP_RESUME_CONTROL`` times that.
65. videos — phase 61's SIGTERM drill on 2 envs with
              ``env.capture_video=True``: env 0's videos alone, each
              decoding to the frames env 0 recorded; no worker maps the
              CUDA driver.  Beside phase 59, the committed snapshot of its
              host ring marks each env's write-head step ``truncated``
              (ROADMAP.md §C 4).
Phases 63, 51's span turns and 43 run on phase 38's kept window, and 44
on 39's, in the graphs group.  Phases 61's children, 59's supervised runs
and 49 run together after 60's timed runs (60's masked run, 62, 64, 17 and
47 while 49's child starts and takes its trace window); phase 52's signal
checks read 49's child afterwards.

Each phase prints its seconds (``[seconds]``).  The line before the last is
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.

Other modes, each alone: ``--timing ROOT`` times the kernels of the port
under ``ROOT``; ``--first-window`` trains the first window of the default
XL recipe (1024 updates, about 12 minutes on an H100); ``--on-policy``
runs phases 16-19 alone, ``--off-policy`` phases 20-24 (they build and
launch no kernel), ``--envs`` phases 25-30, ``--replay`` phases 31-36
(beside host-ring runs of phase 7's and phases 20-22's recipes) and
``--replay-ab`` the host ring and the card's in turns (host, card, card,
host) for DreamerV3-XL, SAC and SAC-AE, timed alike, ``--graphs`` phases
37-41 (after phase 4's served snapshot and captured service run),
``--precision`` phases 42-47 (beside 32-true runs of phases 7 and 11 and
light 32-true windows of phases 38-39),
``--runtime`` phases 48-50, ``--telemetry`` phases 51-53 (beside phase 4's
snapshot, a short SAC run, a light phase 38 window and phase 49's preempted child), ``--deploy`` phases 54-56 (beside phase 4's
snapshot and phase 51's untraced twin), ``--population`` phases 57-59, ``--health-ab ROOT`` phase 7's and 20's
recipes with ``health.enabled`` on and off in turns for the port under
``ROOT``, ``--vecenv`` phases 60-62, 64 and 65 (without 49 and 59),
``--jax-resume`` phases 62 and 64, ``--matmul-precision`` phase 38's XL
window and phase 63 (``--preempt-child`` and ``--commit-hang-child`` are phase 49's
child processes; ``--supervised-child`` is phase 59's, ``--vecenv-child``
phase 61's).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import traceback
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at the 700 W limit
FP32_FLOPS_PER_S = 67e12   # H100 SXM data sheet, fp32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM data sheet, dense TF32 on the tensor cores
TF32_PASSES = 3            # 3xTF32: big*big + big*small + small*big keeps fp32 accuracy
TIMED_BATCHES = (1, 8, 16, 32, 128, 1024)  # serving rungs, posterior-scan rows (16), imagination rows (1024)
PRESETS = {"S": (512, 512), "M": (640, 1024), "L": (768, 2048), "XL": (1024, 4096)}
ZAS = (32 * 32 + 4, 32 * 32 + 6)  # stochastic state + the served 4-wide action, + a 6-wide one
LEADS = ((1,), (7,), (8,), (16,), (32,), (128,), (1024,), (2, 3))  # rungs 1/8/32/128, training 16/1024
TOL = 1e-4
SERVE_SESSIONS, SERVE_STEPS = 16, 8
PRECISION_SERVE_STEPS = 4  # phase 46's steps per session in each of its four turns
# One XL update, fused kernel against the plain RSSM (phase 8), both replaying
# the same categorical samples: max abs difference of the posterior h over
# the 64 steps (phase 3's bound on one call), and relative difference of each
# of the ten losses and of the world-model gradient norm.  Both sit between
# the fused kernel's readings (h 3.2e-06 to 4.0e-06, losses 1.9e-07 relative,
# PERF.md) and those of a plain RSSM whose products take one pass of TF32,
# which must fail them.
TRAIN_TOL_LATENT = 1e-4
TRAIN_TOL_REL = 1e-5
LAUNCHES_PER_UPDATE = 64 + 16  # posterior steps (sequence 64) + imagination steps (horizon 15 + 1)
P2E_LAUNCHES_PER_UPDATE = 64 + 2 * 16  # the posterior scan + the exploration and task rollouts
XL_TRAIN = (
    "exp=dreamer_v3",  # algo=dreamer_v3 is the XL preset
    "env=dummy",
    "env.sync_env=True",
    "env.id=discrete_dummy",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "fabric.accelerator=gpu",
    "algo.player.device=accelerator",
    "metric/logger=csv",
    "checkpoint.save_last=True",
    "checkpoint.every=1000000000",
    "checkpoint.async_save=False",
    "buffer.memmap=False",
    "buffer.checkpoint=False",
    "buffer.size=4096",
    "env.num_envs=1",
    "algo.per_rank_batch_size=16",
    "algo.per_rank_sequence_length=64",
    "algo.horizon=15",
    "algo.learning_starts=65",  # one sequence of 64 steps can be sampled at step 65
    "env.max_episode_steps=32",  # episodes, test episodes among them, of 32 steps, not 128
    "seed=5",
)
# replay ratio 1/8: the first window at step 65 takes int(65 / 8) = 8 updates,
# then one every 8 env steps: 10 updates by step 81
XL_TRAIN_STEPS = ("algo.replay_ratio=0.125", "algo.total_steps=81")
S_TRAIN = (*XL_TRAIN, "algo=dreamer_v3_S", "algo.replay_ratio=0.03125", "algo.total_steps=97",
           "algo.run_test=False", "algo.world_model.recurrent_model.use_pallas=True")
FUSED = "algo.world_model.recurrent_model.fused_pallas=True"
# phases 7 and 20-22 keep the host ring (``buffer.device=auto`` is the card's
# ring): they are the baselines phases 32 and 34 are read beside;
# ``--first-window`` keeps it too (it measures the host path's chunks), and
# phase 59, whose committed ring the replay-tail check reads (§C 4)
HOST_RING = "buffer.device=False"
# replay ratio 1/32: the first window at step 65 takes int(65 / 32) = 2 updates
P2E_XL = ("exp=p2e_dv3_exploration", *XL_TRAIN[1:], FUSED, "algo.replay_ratio=0.03125", "algo.total_steps=65")
# finetuning starts from a state, so it has no random prefill and trains from
# step 66 (learning_starts + 1): int(66 / 32) = 2 updates
P2E_FINETUNE = ("exp=p2e_dv3_finetuning", *XL_TRAIN[1:], FUSED, "algo.replay_ratio=0.03125", "algo.total_steps=66",
                "algo.run_test=False")
DECOUPLED_XL = (*XL_TRAIN, FUSED, "algo.world_model.decoupled_rssm=True", "algo.replay_ratio=0.03125",
                "algo.total_steps=65", "algo.run_test=False")
# the rest of the family at its own default widths: a sequence of 50 can be
# sampled at step 51 (episodes of 55 steps commit to the EpisodeBuffer at
# step 56); replay ratio 0.04 gives int(51 * 0.04) = 2 updates at the first
# window and none more by step 60
FAMILY = (
    "env=dummy", "env.sync_env=True", "env.id=discrete_dummy", "env.max_episode_steps=55", "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]", "fabric.accelerator=gpu", "algo.player.device=accelerator", "metric/logger=csv",
    "checkpoint.save_last=True", "checkpoint.every=1000000000", "checkpoint.async_save=False", "buffer.memmap=False",
    "buffer.checkpoint=False", "buffer.size=4096", "env.num_envs=1", "algo.learning_starts=51",
    "algo.per_rank_pretrain_steps=0", "algo.replay_ratio=0.04", "algo.total_steps=60", "algo.run_test=False",
    "seed=5",
)
FAMILY_RUNS = {
    # exp: extra overrides
    "dreamer_v2": ("buffer.type=episode",),
    "p2e_dv2_exploration": (),
    "dreamer_v1": (),
    "p2e_dv1_exploration": ("buffer.type=episode",),
}
# the on-policy algorithms at their recipes' widths on the dummy env
ON_POLICY = ("env=dummy", "env.sync_env=True", "env.id=discrete_dummy", "fabric.accelerator=gpu", "algo.player.device=accelerator",
             "metric/logger=csv", "checkpoint.save_last=True", "checkpoint.every=1000000000",
             "checkpoint.async_save=False", "buffer.memmap=False", "env.max_episode_steps=32", "seed=5")
ATARI = ("env.screen_size=84", "env.wrapper.image_size=[84,84,3]", "env.frame_stack=4", "env.num_envs=1")
# 2 iterations of 1024 steps, 4 minibatches of 256 x 3 epochs each
PPO_ATARI = ("exp=ppo_atari", *ON_POLICY, *ATARI, "algo.total_steps=2048")
A2C_ATARI = ("exp=a2c_atari", *ON_POLICY, *ATARI, "algo.total_steps=80")  # 2 iterations of 40 steps
RMSPROP_TF = ("algo.optimizer.name=rmsprop_tf", "algo.optimizer.alpha=0.9", "algo.optimizer.eps=1e-10")
# 2 iterations of 128 steps x 4 envs, the recurrent recipe's defaults on the vector observation
# 2 epochs of the recipe's 10: its eager update took 10 s an iteration
PPO_RECURRENT = ("exp=ppo_recurrent", *ON_POLICY, "env.mask_velocities=False", "algo.total_steps=1024",
                 "algo.update_epochs=2")
ON_POLICY_LOSSES = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss")
# One PPO train phase on the card against the CPU (phase 17): the relative L2
# difference of the parameters' changes, and the last losses' relative
# difference.  The gate steps with SGD, not the recipe's Adam: Adam moves a
# parameter by about lr x sign(g) wherever |g| is above its eps, so a
# feature at a ReLU's threshold, zero on one device and 1e-7 on the other,
# becomes a step of a sizeable share of lr, twelve steps compound it, and
# cuDNN's algorithms are not deterministic, so the comparison would move
# from run to run.  With SGD every change is lr x the clipped gradient, and
# a wrong pad or layout shows in it directly; Adam is reported beside it.
CARD_PARITY_SGD = {"name": "sgd", "lr": 0.01, "momentum": 0.0}
CARD = "cuda"  # the device of the phases' card side
CARD_PARITY_TOL_PARAM = 1e-3
CARD_PARITY_TOL_LOSS = 1e-4
# the off-policy algorithms at their recipes' widths on the continuous dummy
# env (phases 20-24); the replay buffer stays out of the snapshots (the SAC-AE
# ring alone would write 2.4 GB)
OFF_POLICY = ("env=dummy", "env.sync_env=True", "env.id=continuous_dummy", "fabric.accelerator=gpu", "algo.player.device=accelerator",
              "metric/logger=csv", "checkpoint.save_last=True", "checkpoint.every=1000000000",
              "checkpoint.async_save=False", "buffer.memmap=False", "buffer.checkpoint=False", "env.num_envs=1",
              "env.max_episode_steps=32", "seed=5")
# a prefill of 100 random steps, which the first window repays (100 updates), then one update per step: 400
SAC_STATE = ("exp=sac", *OFF_POLICY, HOST_RING, "algo.learning_starts=100", "algo.total_steps=400")
# replay ratio 20: the first window at step 20 takes 400 updates, then 20 per step: 600
DROQ_STATE = ("exp=droq", *OFF_POLICY, HOST_RING, "algo.learning_starts=20", "algo.total_steps=30")
# the recipe's prefill of 1,000 steps cut to 128: 128 updates in the first window, then 50 more
SAC_AE_RGB = ("exp=sac_ae", *OFF_POLICY, HOST_RING, "algo.learning_starts=128", "algo.total_steps=178")
# One SAC train phase (U 8, batch 256) and one SAC-AE train phase (U 4, batch
# 128) on the card against the CPU (phase 23), stepped with SGD for every
# group for phase 17's reason; the recipe's Adam is reported beside it.
OFF_POLICY_PARITY = {"sac": (8, 256), "sac_ae": (4, 128)}
XL_SERVE = (
    "exp=dreamer_v3",  # algo=dreamer_v3 is the XL preset
    "env=dummy",
    "env.sync_env=True",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "fabric.accelerator=gpu",
)


def log(*args) -> None:
    print(*args, flush=True)


def _log_seconds(fn):
    """``fn`` logging its wall seconds on a line of its own when it returns or raises."""
    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            log(f"[seconds] {fn.__name__}: {time.perf_counter() - t0:.1f}")
    return timed


def log_phase_seconds() -> None:
    """Make every phase function (and the runs the whole script makes outside
    them) log its seconds; nested phases log their own too."""
    for name in [n for n in globals() if n.startswith("phase_")] + ["_train", "_drive", "time_kernels"]:
        globals()[name] = _log_seconds(globals()[name])


# -- bounds: the least time the card could take for the same work ------------
def _bound(bytes_moved: float, product_flops: float, elementwise_flops: float):
    """The larger of: bytes over the memory rate, the products' 3xTF32
    operations over the tensor cores' TF32 rate, the elementwise operations
    over the fp32 rate of the CUDA cores."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(TF32_PASSES * product_flops / TF32_FLOPS_PER_S, elementwise_flops / FP32_FLOPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gru_bound(B: int, D: int, H: int):
    # inputs x, h, W, LN params read once, h' written once; the product, plus
    # ~8 operations per LayerNorm element and ~12 per gated output
    bytes_moved = 4 * (B * D + B * H + (D + H) * 3 * H + 6 * H + B * H)
    return _bound(bytes_moved, 2 * B * (D + H) * 3 * H, B * (8 * 3 * H + 12 * H))


def rssm_bound(B: int, za: int, D: int, H: int):
    bytes_moved = 4 * (B * za + B * H + za * D + 3 * D + (D + H) * 3 * H + 6 * H + B * H)
    return _bound(bytes_moved, 2 * B * za * D + 2 * B * (D + H) * 3 * H, B * (12 * D + 8 * 3 * H + 12 * H))


# -- timing ------------------------------------------------------------------
def time_ms(torch, fn, samples: int = 21, calls: int = 10) -> float:
    """Median over ``samples`` of CUDA-event time per call, each sample
    ``calls`` back-to-back calls, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(samples):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) / calls for a, b in pairs)


def launch_breakdown(torch, fn, calls: int = 10):
    """Device time of each CUDA launch inside one wrapper call: the
    ``sheeprl::`` kernels that ``calls`` calls of ``fn`` ran, as the CUDA
    profiler saw them, grouped by position in the call.  Returns
    ``([(kernel name, median ms start to end, median ms from the previous
    launch's end to this one's end), ...], median ms from the first launch's
    start to the last one's end)`` in launch order, or ``None`` when three
    captures all missed a launch.  A launch that starts early
    (programmatic dependent launch) and waits shows a long first time; the
    second is what it adds to the step.  The span is the call's device time
    without the host's gaps between calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then misses a launch: take another capture
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA") and "sheeprl::" in e.name),
                        key=lambda e: e.time_range.start)
        if events and len(events) % calls == 0:
            break
    else:
        return None
    per_call = len(events) // calls
    out = []
    for i in range(per_call):
        name = events[i].name.split("sheeprl::", 1)[1].split("(", 1)[0]
        ms = statistics.median((e.time_range.end - e.time_range.start) / 1e3 for e in events[i::per_call])
        past = ms if i == 0 else statistics.median(
            (e.time_range.end - p.time_range.end) / 1e3 for p, e in zip(events[i - 1::per_call], events[i::per_call]))
        out.append((name, ms, past))
    span = statistics.median((events[i + per_call - 1].time_range.end - events[i].time_range.start) / 1e3
                             for i in range(0, len(events), per_call))
    return out, span


# -- phases ------------------------------------------------------------------
def phase_device(torch) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py runs on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}


def phase_build() -> None:
    from sheeprl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build()
    log(f"[build] nvcc built {sorted(reports) or 'nothing (already built)'} in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", line)):
                raise AssertionError(f"ptxas spills registers in {name}.cu: {line.strip()}")


def _rssm_weights(torch, za, D, H, g, dev):
    def rnd(*s, scale=1.0):
        return torch.randn(*s, device=dev, generator=g) * scale

    return (rnd(za, D, scale=za**-0.5), rnd(D, scale=0.1), 1 + rnd(D, scale=0.1), rnd(D, scale=0.1),
            rnd(D + H, 3 * H, scale=(D + H) ** -0.5), 1 + rnd(3 * H, scale=0.1), rnd(3 * H, scale=0.1))


def phase_kernels(torch) -> dict:
    """Every kernel against its plain version; returns the worst error of each."""
    from sheeprl_tpu_torch.ops import gru, rssm

    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(0)
    worst = {"rssm": 0.0, "gru": 0.0}
    for preset, (D, H) in PRESETS.items():
        for za in ZAS:
            w = _rssm_weights(torch, za, D, H, g, dev)
            for lead in LEADS:
                x = torch.randn(*lead, za, device=dev, generator=g)
                y = torch.randn(*lead, D, device=dev, generator=g)
                h = torch.tanh(torch.randn(*lead, H, device=dev, generator=g))
                errs = {"rssm": rssm.fused_rssm_recurrent(x, h, *w) - rssm.rssm_recurrent_reference(x, h, *w)}
                if za == ZAS[0]:  # the GRU cell does not see Z+A
                    errs["gru"] = gru.fused_layernorm_gru(y, h, *w[4:]) - gru.layernorm_gru_reference(y, h, *w[4:])
                errs = {name: float(e.abs().max()) for name, e in errs.items()}
                for name, err in errs.items():
                    worst[name] = max(worst[name], err)
                    if not err <= TOL:
                        raise AssertionError(f"{name} at {preset} Z+A={za} lead {lead}: max abs err {err:.3g} > {TOL}")
                log(f"[kernels] {preset:2s} D={D} H={H} Z+A={za} lead={lead}: "
                    + ", ".join(f"{name} err {err:.2e}" for name, err in errs.items()))
            del w
    return worst


def time_kernels(torch, za, batches) -> dict:
    """Kernel, plain version, the products alone in cuBLAS, the bound and the
    per-launch breakdown at XL for each batch size, with the served model's
    input width ``za`` (stochastic state + actions)."""
    from sheeprl_tpu_torch.ops import gru, rssm

    D, H = PRESETS["XL"]
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(1)
    xl = _rssm_weights(torch, za, D, H, g, dev)
    w_in, w_gru = xl[0], xl[4]
    busy = torch.randn(4096, 4096, device=dev, generator=g)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:  # bring the clocks up before the first timed row
        busy @ busy
        torch.cuda.synchronize()
    del busy
    out = {"rssm": {}, "gru": {}}
    for B in batches:
        x = torch.randn(B, za, device=dev, generator=g)
        y = torch.randn(B, D, device=dev, generator=g)
        h = torch.tanh(torch.randn(B, H, device=dev, generator=g))
        yh = torch.cat([y, h], -1)
        p_in = torch.empty(B, D, device=dev)
        p_gru = torch.empty(B, 3 * H, device=dev)
        rows = {
            "rssm": (lambda: rssm.fused_rssm_recurrent(x, h, *xl), lambda: rssm.rssm_recurrent_reference(x, h, *xl),
                     lambda: (torch.mm(x, w_in, out=p_in), torch.mm(yh, w_gru, out=p_gru)),
                     rssm_bound(B, za, D, H), (B, za, D, H), [w_in, w_gru]),
            "gru": (lambda: gru.fused_layernorm_gru(y, h, *xl[4:]), lambda: gru.layernorm_gru_reference(y, h, *xl[4:]),
                    lambda: torch.mm(yh, w_gru, out=p_gru),
                    gru_bound(B, D, H), (B, D, H), [w_gru]),
        }
        for name, (kernel, plain, products, (bound_ms, bound_by), shape, weights) in rows.items():
            k_ms, p_ms, lib_ms = time_ms(torch, kernel), time_ms(torch, plain), time_ms(torch, products)
            breakdown = launch_breakdown(torch, kernel)
            launches, span = breakdown if breakdown else (None, None)
            out[name][B] = {"ms": k_ms, "plain_ms": p_ms, "gemm_library_ms": lib_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "device_span_ms": span, "shape": shape, "breakdown": launches}
            log(f"[timing] {name} XL B={B}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, cuBLAS fp32 products "
                f"alone {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), bound/kernel {bound_ms / k_ms:.1%}")
            if launches is None:
                log(f"[timing] {name} B={B}: per-launch breakdown not measured (the profiler missed launches)")
                continue
            log(f"[breakdown] {name} B={B}: device span of one call {span:.4f} ms")
            # GEMM launches stream the weights in argument order (W_in, then W_gru)
            gemm_bytes = iter(4 * w.numel() for w in weights)
            for i, (kname, ms, past) in enumerate(launches):
                rate = f", weight stream {next(gemm_bytes) / ms / 1e9:.3f} TB/s" if "gemm" in kname else ""
                log(f"[breakdown] {name} B={B} launch {i + 1} {kname}: {ms:.4f} ms, {past:.4f} ms past the "
                    f"previous launch's end{rate}")
    return out


def _build_snapshot(torch, overrides, run_dir: Path) -> None:
    """A run directory with config.yaml and one committed snapshot of an
    agent initialised on the card from the config's seed."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.checkpoint.protocol import write_snapshot
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.serve.loader import probe_spaces, write_run_config

    t0 = time.perf_counter()
    cfg = compose(list(overrides))
    fabric = build_fabric(cfg)
    obs_space, action_space = probe_spaces(cfg)
    dims, cont = spaces_to_dims(action_space)
    modules = build_agent(fabric, dims, cont, cfg, obs_space)
    n_params = sum(p.numel() for name in ("world_model", "actor", "critic") for p in modules[name].parameters())
    write_run_config(run_dir, cfg)
    write_snapshot(run_dir / "checkpoint", 1, {"agent": {n: m.state_dict() for n, m in modules.items()}})
    del modules
    torch.cuda.empty_cache()
    log(f"[serve] built and committed a {n_params / 1e6:.1f} M-parameter agent "
        f"(world model + actor + critic) in {time.perf_counter() - t0:.1f} s")


def _client_sessions(url: str, player, valid, sessions: int, steps: int):
    """``sessions`` concurrent HTTP sessions of ``steps`` requests each against
    ``url``, greedy and sampled rows mixed, every action checked by
    ``valid``; returns the wall seconds and the client latencies."""
    from sheeprl_tpu_torch.serve.client import PolicyClient

    spec = player.obs_spec
    latencies, errors = [], []
    lock = threading.Lock()

    def session(i: int) -> None:
        client = PolicyClient(url, packed=True, timeout=120)
        rng = np.random.default_rng(i)
        try:
            for step in range(steps):
                obs = {k: rng.integers(0, 256, shape, dtype=np.uint8) if dtype == "uint8"
                       else rng.standard_normal(shape).astype(np.float32) for k, (shape, dtype) in spec.items()}
                t = time.perf_counter()
                action = client.act(obs, session=f"s{i}", greedy=(i + step) % 2 == 0)
                dt = time.perf_counter() - t
                if not valid(action):
                    raise AssertionError(f"invalid action {action!r} for the action space of {player.algo}")
                with lock:
                    latencies.append(dt)
        except BaseException as e:  # noqa: BLE001 - re-raised on the main thread
            errors.append(e)

    t_run = time.perf_counter()
    threads = [threading.Thread(target=session, args=(i,)) for i in range(sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t_run
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client session did not finish within 300 s")
    if errors:
        raise errors[0]
    return wall, latencies


def _action_check(service):
    """Whether an action is valid for the service's action space."""
    player = service.player
    if player.is_continuous:
        from sheeprl_tpu_torch.serve.loader import probe_spaces

        space = probe_spaces(service.cfg)[1]
        return lambda a: a.shape == player.action_shape and bool(np.all((a >= space.low) & (a <= space.high)))
    return lambda a: a.shape == player.action_shape and 0 <= int(a) < int(player.actions_dim[0])


def _drive(torch, run_dir: Path, sessions: int, steps: int, eager: bool = False) -> dict:
    """Serve ``run_dir`` over HTTP to ``sessions`` concurrent sessions of
    ``steps`` requests, with every launch count zeroed just before and read
    just after.  Returns the service's stats, the client latencies and the
    counts.  ``eager`` serves the unwrapped step (the A/B of phase 40): the
    player's ``dispatch`` through ``fabric.compile`` is taken out."""
    from sheeprl_tpu_torch.ops import gru, rssm
    from sheeprl_tpu_torch.serve.client import PolicyClient
    from sheeprl_tpu_torch.serve.server import PolicyServer
    from sheeprl_tpu_torch.serve.service import PolicyService

    t0 = time.perf_counter()
    service = PolicyService.from_checkpoint(run_dir)
    log(f"[serve] PolicyService.from_checkpoint: {time.perf_counter() - t0:.1f} s on {service.player.device}"
        f"{', the step eager (unwrapped)' if eager else ''}")
    if eager:
        service.player.dispatch = None
    player = service.player
    valid = _action_check(service)
    rssm.LAUNCHES["rssm"] = gru.LAUNCHES["gru"] = 0
    server = PolicyServer(service, port=0)
    t_warm = time.perf_counter()
    server.start()
    log(f"[serve] warm-up of ladder {list(service.ladder)}: {time.perf_counter() - t_warm:.1f} s; {server.url}")
    try:
        wall, latencies = _client_sessions(server.url, player, valid, sessions, steps)
        stats = PolicyClient(server.url).stats()
        health = PolicyClient(server.url).health()
    finally:
        server.stop()
    counts = {"rssm": rssm.LAUNCHES["rssm"], "gru": gru.LAUNCHES["gru"]}
    if not health["ok"]:
        raise AssertionError(f"/healthz: {health}")
    if stats["served"] != sessions * steps or stats["errors"]:
        raise AssertionError(f"/v1/stats served {stats['served']} (errors {stats['errors']}), sent {sessions * steps}")
    lat = np.asarray(latencies) * 1e3
    log(f"[serve] {sessions} sessions x {steps} steps: {stats['served']} actions in {wall:.2f} s = "
        f"{stats['served'] / wall:.1f} actions/s; client p50 {np.percentile(lat, 50):.1f} ms "
        f"p99 {np.percentile(lat, 99):.1f} ms; service p50 {stats['p50_ms']:.1f} ms p99 {stats['p99_ms']:.1f} ms; "
        f"batches {stats['batches']} rungs {stats['rungs']} avg batch {stats['avg_batch']}; launches {counts}")
    return {"stats": stats, "counts": counts, "service": service, "actions_per_s": stats["served"] / wall}


def main_rung(stats) -> int:
    """The ladder rung the service dispatched most (the larger on a tie)."""
    return max(((int(s), n) for s, n in stats["rungs"].items()), key=lambda sn: (sn[1], sn[0]))[0]


def phase_parity(torch, service, B: int) -> float:
    """One served step (the kernel) of ``B`` rows against the same step with
    ``rssm_recurrent_reference`` called directly, under shared noise."""
    from sheeprl_tpu_torch.ops.rssm import rssm_recurrent_reference
    from sheeprl_tpu_torch.utils.distribution import OneHotCategorical

    player = service.player
    wm, actor = player.params["world_model"], player.params["actor"]
    dev = player.device
    g = torch.Generator(dev).manual_seed(7)
    rng = np.random.default_rng(7)
    raw = {"rgb": rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8),
           "state": rng.standard_normal((B, 4)).astype(np.float32)}
    obs = {k: torch.from_numpy(v).to(dev) for k, v in player.prepare(raw).items()}
    h = torch.tanh(torch.randn(B, wm.recurrent_size, device=dev, generator=g))
    z = torch.nn.functional.one_hot(torch.randint(0, wm.discrete_size, (B, wm.stochastic_size), device=dev,
                                                  generator=g), wm.discrete_size).float().reshape(B, -1)
    a = torch.nn.functional.one_hot(torch.randint(0, 4, (B,), device=dev, generator=g), 4).float()
    noise = wm.posterior_noise(B, g)
    greedy = torch.ones(B, dtype=torch.bool, device=dev)
    with torch.inference_mode():
        (h_k, z_k, a_k), _ = player.step(player.params, (h, z, a), obs, 11, greedy, post_noise=noise)
        rm = wm.recurrent_model
        h_r = rssm_recurrent_reference(torch.cat([z, a], -1), h, rm.in_kernel, rm.in_bias, rm.ln_scale,
                                       rm.ln_bias, rm.gru_kernel, rm.gru_ln_scale, rm.gru_ln_bias)
        post = wm._logits_reshape(wm.representation_model(torch.cat([h_r, wm.encode(obs)], -1)))
        z_r = OneHotCategorical(post, unimix=wm.unimix).rsample_from_noise(noise).reshape(B, -1)
        a_r = actor.sample(actor(torch.cat([z_r, h_r], -1)), g, greedy=True)
    torch.cuda.synchronize()
    err = float((h_k - h_r).abs().max())
    shape = (B, wm.stochastic_size, wm.discrete_size)
    same_z = bool(torch.equal(z_k.reshape(shape).argmax(-1), z_r.reshape(shape).argmax(-1)))
    same_a = bool(torch.equal(a_k.argmax(-1), a_r.argmax(-1)))
    finite = bool(torch.isfinite(h_k).all() and torch.isfinite(z_k).all())
    log(f"[parity] served step vs plain RSSM, B={B}: h max abs err {err:.2e}, z equal {same_z}, "
        f"greedy actions equal {same_a}, finite {finite}")
    if not (err <= TOL and same_z and same_a and finite):
        raise AssertionError("the served step disagrees with the plain RSSM step")
    return err


# -- training ----------------------------------------------------------------
LOSS_NAMES = ("Loss/world_model_loss", "Loss/observation_loss", "Loss/reward_loss", "Loss/state_loss",
              "Loss/continue_loss", "State/kl", "Loss/policy_loss", "Loss/value_loss", "State/post_entropy",
              "State/prior_entropy")


WINDOW_NAMES = (".train_phase", ".train_phase_device")  # the Dreamer loop's window routes


def _train(torch, overrides, log_dir: Path, kernel, per_update_launches: int = LAUNCHES_PER_UPDATE,
           trainer_cls=None, metric_names=LOSS_NAMES, events_only: bool = False, snapshot: bool = True) -> dict:
    """One training run through ``cli.run`` with every launch count zeroed
    just before and read just after.  Every call of the loop's train window
    (``fabric.compile``'s route ``<algo>.train_phase[_device]``: a chunk of
    ``U`` updates, one captured CUDA graph per chunk size for DreamerV3 on
    the card, eager for the rest of the family) is timed with the device
    synchronised around it and counted with its launches; an update's numbers
    are its chunk's over ``U``.  ``kernel`` (``rssm`` or ``gru``) must launch
    ``per_update_launches`` times in every update (a replay is credited with
    the launches its graph recorded); ``None``: no kernel may launch at all.
    ``trainer_cls`` is the run's trainer (DreamerV3's by default): an eager
    one with an intrinsic reward (Plan2Explore) has it read after every
    update.  Every chunk is also timed by CUDA events around it
    (``updates_per_s_events``); with ``events_only`` (a run whose windows run
    under ``steady_guard``, where the host may not wait on the device) those
    are its only times.  ``first_update_s`` is the first chunk's time, its
    capture included, over its updates.  Without ``snapshot`` the run saves
    no final snapshot (an XL one writes ≈ 2.6 GB to the disk), and its
    trainer is returned under ``"trainer"`` instead."""
    import csv

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.ops import gru, rssm
    from sheeprl_tpu_torch.parallel.compile import GraphFunction

    trainer_cls = trainer_cls or DV3Trainer

    def counts_now():
        return {"rssm": rssm.LAUNCHES["rssm"], "gru": gru.LAUNCHES["gru"]}

    seconds, launches, intrinsic, events, chunks, graphed, built = [], [], [], [], [], [], []
    call = GraphFunction.__call__
    train_step = trainer_cls.train_step

    def timed_call(self, *args, **kwargs):
        if not self.name.endswith(WINDOW_NAMES):
            return call(self, *args, **kwargs)
        U = int(args[0])
        if not events_only:
            torch.cuda.synchronize()
        entries = self.cache_size()
        t0, before = time.perf_counter(), counts_now()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = call(self, *args, **kwargs)
        end.record()
        events.append((start, end, U))
        if not events_only:
            torch.cuda.synchronize()
            seconds.extend([(time.perf_counter() - t0) / U] * U)
        delta = {k: n - before[k] for k, n in counts_now().items()}
        if any(n % U for n in delta.values()):
            raise AssertionError(f"a chunk of {U} updates launched {delta}: not a whole number per update")
        launches.extend([{k: n // U for k, n in delta.items()}] * U)
        chunks.append(U)
        graphed.append(self.graphs)
        built.extend([self.cache_size() > entries] * U)  # this chunk's first call: eager, then captured
        return out

    def step_with_intrinsic(self, *args, **kwargs):
        out = train_step(self, *args, **kwargs)
        if not events_only and getattr(self, "last_intrinsic", None) is not None:
            intrinsic.append(float(self.last_intrinsic))
        return out

    trainers = []
    init = trainer_cls.__init__

    def kept_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        trainers.append(self)

    gc.collect()  # modules held in reference cycles by an earlier run would count in this run's peak
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rssm.LAUNCHES["rssm"] = gru.LAUNCHES["gru"] = 0
    GraphFunction.__call__ = timed_call
    if trainer_cls.graph_eager_reason is not None:  # eager: read per update (a graph replays no Python)
        trainer_cls.train_step = step_with_intrinsic
    if not snapshot:
        trainer_cls.__init__ = kept_init
        overrides = [*overrides, "checkpoint.save_last=False"]
    t0 = time.perf_counter()
    try:
        run([*overrides, f"log_dir={log_dir}"])
    finally:
        GraphFunction.__call__ = call
        trainer_cls.train_step = train_step
        trainer_cls.__init__ = init
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    event_s = [a.elapsed_time(b) / 1e3 / U for a, b, U in events for _ in range(U)]
    if events_only:
        seconds = event_s
    counts = counts_now()
    peak = torch.cuda.max_memory_allocated()
    snapshots = sorted(log_dir.glob("**/checkpoint/step_*"))
    if snapshot and not snapshots:
        raise AssertionError(f"the training run committed no snapshot under {log_dir}")
    with open(next(log_dir.glob("**/metrics.csv"))) as f:
        logged = {name: float(value) for _, name, value in list(csv.reader(f))[1:]}
    missing = [n for n in metric_names if n not in logged or not np.isfinite(logged[n])]
    if missing:
        raise AssertionError(f"metrics missing or not finite: {missing}")
    if not seconds:
        raise AssertionError(f"the run under {log_dir} made no update")
    if kernel is None:
        if any(counts.values()):
            raise AssertionError(f"a run whose model takes no kernel flag launched kernels: {counts}")
        per_update = [0] * len(launches)
    else:
        per_update = [n[kernel] for n in launches]
        if any(n != per_update_launches for n in per_update):
            raise AssertionError(f"{kernel} launches per update {per_update}, expected {per_update_launches} each")
    if intrinsic and not np.isfinite(intrinsic).all():
        raise AssertionError(f"intrinsic reward not finite: {intrinsic}")
    # the steady rate: updates in chunks that replayed an entry built earlier
    # (a chunk size's first call runs eagerly and then captures); failing
    # those, every chunk after the first
    first_chunk = chunks[0]
    replayed = [i for i, b in enumerate(built) if not b] or list(range(first_chunk, len(seconds))) or [0]
    steady = statistics.median(seconds[i] for i in replayed)
    steady_events = statistics.median(event_s[i] for i in replayed)
    out = {"updates": len(seconds), "first_update_s": seconds[0], "first_chunk_s": seconds[0] * first_chunk,
           "updates_per_s": 1.0 / steady, "updates_per_s_events": 1.0 / steady_events, "event_s": event_s,
           "median_update_s": steady, "peak_bytes": peak, "counts": counts, "per_update": per_update,
           "update_launches": launches, "chunks": chunks, "captured": all(graphed),
           "replayed_updates": sum(not b for b in built),
           "snapshot": snapshots[-1] if snapshot else None, "wall_s": wall,
           "logged": {n: logged[n] for n in metric_names}, "intrinsic": intrinsic}
    if not snapshot:
        out["trainer"] = trainers[-1]
    log(f"[train] {len(seconds)} updates in chunks {chunks} ({'CUDA graphs' if all(graphed) else 'eager'}; "
        f"{out['replayed_updates']} of them in chunks that reused an entry) in a {wall:.1f} s run: first chunk "
        f"{out['first_chunk_s']:.3f} s, then median {steady:.4f} s = "
        f"{1.0 / steady:.3f} updates/s ({'CUDA events' if events_only else 'wall'}; by CUDA events "
        f"{1.0 / steady_events:.3f} updates/s); peak device memory {peak / 2**30:.2f} GiB; {kernel} launches per "
        f"update {sorted(set(per_update))}, run total {counts}")
    log("[train] metrics " + ", ".join(f"{n} {logged[n]:.6g}" for n in metric_names)
        + (f"; intrinsic reward per update {', '.join(f'{x:.6g}' for x in intrinsic)}" if intrinsic else ""))
    return out


# kernel-name markers of the kinds of device work in an update (first match wins)
PROFILE_GROUPS = (
    ("the port's RSSM kernel (sheeprl::)", ("sheeprl::",)),
    ("convolutions (cuDNN)", ("cudnn", "conv", "implicit_gemm", "wgrad", "dgrad", "fprop")),
    ("matrix products (cuBLAS / CUTLASS: linears, the plain RSSM backward)", ("gemm", "gemv", "Kernel2")),
)


def _device_events(prof) -> list:
    """``(name, ms)`` of every device operation (kernel, copy, fill) a
    finished ``torch.profiler.profile`` recorded, read from its raw results:
    its event tree (``events()``, ``key_averages()``) links every kernel to
    its host call in Python and takes seconds for tens of thousands of
    kernels."""
    from torch._C import _demangle
    from torch.autograd import DeviceType

    names, out = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or getattr(e, "is_hidden_event", lambda: False)():
            continue
        raw = e.name()
        name = names.get(raw)
        if name is None:
            name = names[raw] = _demangle(raw) if len(raw) > 1 else raw
        out.append((name, (e.end_ns() - e.start_ns()) / 1e6))
    return out


def _log_profile(tag: str, prof, wall_ms: float, what: str, wall_note: str = "") -> tuple:
    """The profiler's device time of ``what``: the total against ``wall_ms``
    (the device's busy and idle shares), the top 10 kernels and the sums by
    kind; returns (total device ms, launches)."""
    rows = {}
    for name, ms in _device_events(prof):
        ms0, n0 = rows.get(name, (0.0, 0))
        rows[name] = (ms0 + ms, n0 + 1)
    rows = {name: row for name, row in rows.items() if row[0] > 0}
    total = sum(ms for ms, _ in rows.values())
    launches = sum(n for _, n in rows.values())
    log(f"[{tag} profile] {what}: {total:.1f} ms of device time in {launches} kernel launches; the same "
        f"unprofiled takes {wall_ms:.1f} ms of wall time{' ' + wall_note if wall_note else ''}, so the device is "
        f"busy {total / wall_ms:.1%} of it and idle {1 - total / wall_ms:.1%} (kernels that overlap count twice)")
    for name, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[{tag} profile] {ms:9.3f} ms {ms / total:6.1%} x{n:5d} {name[:110]}")
    groups = {}
    for name, (ms, n) in rows.items():
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)), "other (elementwise, reductions, copies)")
        ms0, n0 = groups.get(group, (0.0, 0))
        groups[group] = (ms0 + ms, n0 + n)
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"[{tag} profile] by kind: {group}: {ms:.1f} ms ({ms / total:.1%}) in {n} launches")
    return total, launches


def _trainer_from_snapshot(torch, snapshot: Path):
    """The trainer of the snapshot's run (DreamerV3, or Plan2Explore-DV3
    exploration), with the snapshot's weights and optimizer state."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_dv3_optimizers
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as p2e
    from sheeprl_tpu_torch.algos.p2e_utils import p2e_optimizers
    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.serve.loader import load_run_config, probe_spaces

    cfg = load_run_config(snapshot, ["fabric.accelerator=gpu"])
    fabric = build_fabric(cfg)
    state = fabric.load(snapshot)
    obs_space, action_space = probe_spaces(cfg)
    dims, cont = spaces_to_dims(action_space)
    if cfg.algo.name == "p2e_dv3_exploration":
        build, make_trainer, build_opts = p2e.build_agent, p2e.P2EDV3Trainer, p2e_optimizers
    else:
        build, make_trainer, build_opts = build_agent, DV3Trainer, build_dv3_optimizers
    modules = build(fabric, dims, cont, cfg, obs_space, state["agent"])
    trainer = make_trainer(cfg, modules, build_opts(cfg, modules, state["opt_state"]),
                           tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder), cont, state["agent"])
    return cfg, trainer, dims


def _tf32(torch, t):
    """``t`` rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero, as the tensor cores' one-pass input conversion), with the gradient
    passed straight through."""
    bits = (t.detach().contiguous().view(torch.int32) + 0x1000) & -0x2000
    return t + (bits.view(torch.float32) - t).detach()


def _rssm_variant(torch, eps_in: float, eps_gru: float, swap_gates: bool, tf32: bool = False):
    """The plain RSSM step with its LayerNorm eps, gate order and product
    precision as given (the port's plain version is eps_in 1e-3, eps_gru
    1e-5, no swap, fp32 products)."""
    from sheeprl_tpu_torch.ops._common import layer_norm

    def mm(a, b):
        return _tf32(torch, a) @ _tf32(torch, b) if tf32 else a @ b

    def step(x, h, w_in, b_in, ln_in_scale, ln_in_bias, w_gru, gru_scale, gru_bias):
        y = torch.nn.functional.silu(layer_norm(mm(x, w_in) + b_in, ln_in_scale, ln_in_bias, eps_in))
        parts = layer_norm(mm(torch.cat([y, h], -1), w_gru), gru_scale, gru_bias, eps_gru)
        H = h.shape[-1]
        r, c, u = parts[..., :H], parts[..., H:2 * H], parts[..., 2 * H:]
        if swap_gates:
            r, u = u, r
        update = torch.sigmoid(u - 1.0)
        return update * torch.tanh(torch.sigmoid(r) * c) + (1.0 - update) * h

    return step


def phase_train_parity(torch, snapshot: Path, tag: str = "train-parity", controls: bool = True) -> dict:
    """One XL update from ``snapshot`` on the same data and noise: the fused
    kernel, the plain RSSM, and (``controls``) three faulty plain versions;
    plus the profiler top-10 of the fused update.  Log lines carry ``tag``."""
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.algos.dreamer_v3 import agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import blocks_to_device, draw_noise
    from sheeprl_tpu_torch.ops.rssm import LN_GRU_EPS, LN_IN_EPS, rssm_recurrent_reference
    from sheeprl_tpu_torch.utils.distribution import OneHotCategorical

    gc.collect()
    torch.cuda.empty_cache()
    cfg, trainer, dims = _trainer_from_snapshot(torch, snapshot)
    L, B, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size), int(cfg.algo.horizon)
    rng = np.random.default_rng(9)
    block = {
        "rgb": rng.integers(0, 256, (1, L, B, 64, 64, 3), dtype=np.uint8),
        "state": rng.standard_normal((1, L, B, 4)).astype(np.float32),
        "actions": np.eye(dims[0], dtype=np.float32)[rng.integers(0, dims[0], (1, L, B))],
        "rewards": rng.standard_normal((1, L, B, 1)).astype(np.float32),
        "terminated": (rng.random((1, L, B, 1)) < 0.02).astype(np.float32),
        "is_first": (rng.random((1, L, B, 1)) < 0.02).astype(np.float32),
    }
    dev = trainer.device
    blocks = blocks_to_device(block, trainer.cnn_keys, trainer.mlp_keys, dev)
    noise = draw_noise(trainer.world_model, trainer.actor, 1, L, B, H, torch.Generator(dev).manual_seed(9),
                       trainer.task_rollout)
    start = trainer.snapshot()
    captured = {}
    wm_forward = trainer.wm_forward
    stoch_flat = trainer.world_model.stoch_flat

    def recording(data, post_noise):
        loss, aux = wm_forward(data, post_noise)
        captured["h"] = aux["latents"][..., stoch_flat:].detach()
        return loss, aux

    trainer.wm_forward = recording
    fused = agent.fused_rssm_recurrent
    # Every run replays the categorical samples (posterior, actions,
    # imagination) of the first, so a near-tie that the kernel's rounding
    # tips the other way cannot fork a trajectory: the runs differ by their
    # arithmetic alone.  The straight-through gradient does not depend on
    # which sample was drawn.
    samples, replay = [], {"on": False, "i": 0}
    sample_from_noise = OneHotCategorical.sample_from_noise

    def recorded_sample(self, noise):
        if replay["on"]:
            replay["i"] += 1
            return samples[replay["i"] - 1]
        out = sample_from_noise(self, noise)
        samples.append(out)
        return out

    def update(step_fn, profiled: bool = False):
        trainer.restore(start)
        agent.fused_rssm_recurrent = step_fn
        OneHotCategorical.sample_from_noise = recorded_sample
        replay["i"] = 0
        try:
            if profiled:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    metrics = trainer.train_phase(blocks, noise, 1)
                    torch.cuda.synchronize()
            else:
                metrics = trainer.train_phase(blocks, noise, 1)
        finally:
            agent.fused_rssm_recurrent = fused
            OneHotCategorical.sample_from_noise = sample_from_noise
        if replay["on"] and replay["i"] != len(samples):
            raise AssertionError(f"the run drew {replay['i']} categorical samples, the recording {len(samples)}")
        replay["on"] = True
        out = {"metrics": np.array([float(m) for m in metrics]), "grad_norm": float(trainer.last_wm_grad_norm),
               "h": captured["h"].clone()}
        return (out, prof) if profiled else out

    update(fused)  # warm-up; records the samples every later run replays
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    update(fused)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    log(f"[{tag}] one fused XL update (with its restore): {wall_ms:.1f} ms, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    kernel, prof = update(fused, profiled=True)
    plain = update(rssm_recurrent_reference)

    def diffs(run):
        rel = np.abs(run["metrics"] - plain["metrics"]) / np.maximum(np.abs(plain["metrics"]), 1e-6)
        return {"loss_rel": float(rel.max()), "loss_rel_each": rel,
                "grad_norm_rel": abs(run["grad_norm"] - plain["grad_norm"]) / abs(plain["grad_norm"]),
                "latent_abs": float((run["h"] - plain["h"]).abs().max())}

    def within(d):
        return d["loss_rel"] <= TRAIN_TOL_REL and d["grad_norm_rel"] <= TRAIN_TOL_REL and d["latent_abs"] <= TRAIN_TOL_LATENT

    got = diffs(kernel)
    log(f"[{tag}] fused vs plain RSSM, one XL update ({len(samples)} sampling calls replayed): losses max "
        f"rel diff {got['loss_rel']:.3g} ({', '.join(f'{x:.2e}' for x in got['loss_rel_each'])}), world-model grad "
        f"norm rel diff {got['grad_norm_rel']:.3g} ({kernel['grad_norm']:.6g} vs {plain['grad_norm']:.6g}), "
        f"posterior h max abs diff {got['latent_abs']:.3g}; tolerance rel {TRAIN_TOL_REL}, h {TRAIN_TOL_LATENT:.3g}")
    if not (within(got) and np.isfinite(kernel["metrics"]).all()):
        raise AssertionError("the fused-kernel update disagrees with the plain-RSSM update")
    variants = (("LayerNorm eps swapped", _rssm_variant(torch, LN_GRU_EPS, LN_IN_EPS, False)),
                ("reset/update gates swapped", _rssm_variant(torch, LN_IN_EPS, LN_GRU_EPS, True)),
                ("one-pass TF32 products", _rssm_variant(torch, LN_IN_EPS, LN_GRU_EPS, False, tf32=True)))
    faults = {}
    for name, variant in variants if controls else ():
        bad = faults[name] = diffs(update(variant))
        log(f"[{tag}] {name}: losses max rel diff {bad['loss_rel']:.3g}, grad norm rel diff "
            f"{bad['grad_norm_rel']:.3g}, posterior h max abs diff {bad['latent_abs']:.3g}")
        if within(bad):
            raise AssertionError(f"the parity tolerance does not catch a plain RSSM with the {name}")

    total, launches = _log_profile(tag, prof, wall_ms, "one XL update", "(with its restore)")
    del trainer, start
    torch.cuda.empty_cache()
    return {"diffs": got, "controls": faults, "profile_total_ms": total, "wall_ms": wall_ms, "launches": launches}


def phase_serve_trained(torch, snapshot: Path) -> None:
    from sheeprl_tpu_torch.serve.loader import load_policy

    _, _, _, player = load_policy(snapshot, ["fabric.accelerator=gpu"])
    rng = np.random.default_rng(3)
    raw = {"rgb": rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8),
           "state": rng.standard_normal((1, 4)).astype(np.float32)}
    carry, actions = player.step_batch(player.params, player.zero_carry(1), player.prepare(raw), 0,
                                       np.array([True]))
    action = player.postprocess(actions)
    n_actions = int(player.actions_dim[0])
    if not (np.isfinite(carry[0]).all() and action.shape == (1,) and 0 <= int(action[0]) < n_actions):
        raise AssertionError(f"invalid served step from the trained snapshot: action {action!r}")
    log(f"[serve-trained] {snapshot.name} on {player.device}: greedy action {int(action[0])} of {n_actions}")


def phase_p2e_finetune(torch, explore_snapshot: Path, log_dir: Path) -> dict:
    """Finetuning from the exploration snapshot: 80 rssm launches per update,
    the actor at load equal to the snapshot's task actor bit for bit, and the
    finetuned snapshot evaluated once through ``cli.evaluation``."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer
    from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
    from sheeprl_tpu_torch.cli import evaluation

    at_load = {}
    init = DV3Trainer.__init__

    def capture(self, cfg, modules, *args, **kwargs):
        at_load.update({k: v.detach().cpu().clone() for k, v in modules["actor"].state_dict().items()})
        init(self, cfg, modules, *args, **kwargs)

    DV3Trainer.__init__ = capture
    try:
        out = _train(torch, [*P2E_FINETUNE, f"checkpoint.exploration_ckpt_path={explore_snapshot}"], log_dir, "rssm")
    finally:
        DV3Trainer.__init__ = init
    task_actor = load_step_dir(explore_snapshot, map_location="cpu")["agent"]["actor_task"]
    if set(at_load) != set(task_actor) or not all(torch.equal(at_load[k], v) for k, v in task_actor.items()):
        raise AssertionError("the finetuning actor at load is not the exploration snapshot's task actor")
    log(f"[p2e-finetune] the actor at load equals the exploration snapshot's actor_task in all "
        f"{len(task_actor)} tensors, bit for bit")
    t0 = time.perf_counter()
    reward = evaluation([f"checkpoint_path={out['snapshot']}", "fabric.accelerator=gpu"])
    if not np.isfinite(reward):
        raise AssertionError(f"cli.evaluation of the finetuned snapshot gave {reward}")
    log(f"[p2e-finetune] cli.evaluation of {out['snapshot'].name}: cumulative reward {reward} in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def phase_family(torch, run_root: Path) -> dict:
    """DreamerV2, Plan2Explore-DV2, DreamerV1 and Plan2Explore-DV1 at their
    default widths through ``cli.run``: 2 updates each, metrics finite (the
    intrinsic reward of every Plan2Explore update too), no kernel launch."""
    from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import DV1Trainer
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import DV2Trainer

    out = {}
    for exp, extra in FAMILY_RUNS.items():
        log(f"[family] {exp} {' '.join(extra)}")
        v1 = "v1" in exp
        out[exp] = _train(torch, [f"exp={exp}", *FAMILY, *extra], run_root / exp, None,
                          trainer_cls=DV1Trainer if v1 else DV2Trainer,
                          metric_names=LOSS_NAMES[:8] if v1 else LOSS_NAMES, snapshot=False)
        out[exp].pop("trainer")
        if out[exp]["updates"] < 2:
            raise AssertionError(f"{exp} ran {out[exp]['updates']} updates, expected 2")
        if exp.startswith("p2e") and len(out[exp]["intrinsic"]) != out[exp]["updates"]:
            raise AssertionError(f"{exp}: an intrinsic reward for {len(out[exp]['intrinsic'])} of "
                                 f"{out[exp]['updates']} updates")
    return out


# -- the on-policy algorithms ------------------------------------------------
def _train_on_policy(torch, overrides, log_dir: Path, trainer_cls, keep_last: bool = False) -> dict:
    """One on-policy run through ``cli.run`` with every launch count zeroed
    just before and read just after (none may launch), each update timed
    with the device synchronised around it; an iteration is the time from
    one update's end to the next one's (the rollout and the update).
    ``keep_last`` keeps the last update's trainer and arguments."""
    import csv

    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.ops import gru, rssm

    ends, updates, kept = [], [], {}
    train_phase = trainer_cls.train_phase

    def timed(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_phase(self, *args, **kwargs)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        updates.append(ends[-1] - t0)
        if keep_last:
            kept.update(trainer=self, args=args)
        return out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rssm.LAUNCHES["rssm"] = gru.LAUNCHES["gru"] = 0
    trainer_cls.train_phase = timed
    t0 = time.perf_counter()
    try:
        run([*overrides, f"log_dir={log_dir}"])
    finally:
        trainer_cls.train_phase = train_phase
    wall = time.perf_counter() - t0
    counts = {"rssm": rssm.LAUNCHES["rssm"], "gru": gru.LAUNCHES["gru"]}
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        raise AssertionError(f"an on-policy run launched kernels: {counts}")
    snapshots = sorted(log_dir.glob("**/checkpoint/step_*"))
    if not snapshots or not ends:
        raise AssertionError(f"the run under {log_dir} made {len(ends)} updates and {len(snapshots)} snapshots")
    with open(next(log_dir.glob("**/metrics.csv"))) as f:
        logged = {name: float(value) for _, name, value in list(csv.reader(f))[1:]}
    missing = [n for n in ON_POLICY_LOSSES if n not in logged or not np.isfinite(logged[n])]
    if missing:
        raise AssertionError(f"metrics missing or not finite: {missing}")
    iters = [ends[0] - t0] + [b - a for a, b in zip(ends, ends[1:])]
    steady = statistics.median(iters[1:]) if len(iters) > 1 else iters[0]
    out = {"iterations": len(ends), "first_iteration_s": iters[0], "iteration_s": iters, "update_s": updates,
           "iterations_per_s": 1.0 / steady, "peak_bytes": peak, "counts": counts, "snapshot": snapshots[-1],
           "wall_s": wall, "logged": {n: logged[n] for n in ON_POLICY_LOSSES}, **kept}
    log(f"[{log_dir.name}] {len(ends)} iterations in a {wall:.1f} s run: first iteration {iters[0]:.3f} s (with "
        f"the run's start), then {', '.join(f'{x:.3f}' for x in iters[1:])} s = {out['iterations_per_s']:.3f} "
        f"iterations/s; updates {', '.join(f'{x:.3f}' for x in updates)} s; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {counts}")
    log(f"[{log_dir.name}] metrics " + ", ".join(f"{n} {logged[n]:.6g}" for n in ON_POLICY_LOSSES))
    return out


def phase_ppo_train(torch, log_dir: Path) -> dict:
    """PPO at its Atari widths, 2 iterations; the rates, and a profile of
    one update (the last iteration's train phase run again)."""
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer

    out = _train_on_policy(torch, PPO_ATARI, log_dir, PPOTrainer, keep_last=True)
    steps = 1024 * out["iterations"]
    trainer, (rollout, last_obs, _, clip, ent) = out.pop("trainer"), out.pop("args")
    if out["iterations"] != 2 or trainer.num_minibatches * trainer.update_epochs != 12:
        raise AssertionError(f"{out['iterations']} iterations of {trainer.num_minibatches} x {trainer.update_epochs}"
                             " minibatch steps, expected 2 of 4 x 3")
    out["env_steps_per_s"] = 1024 * out["iterations_per_s"]
    log(f"[ppo-train] {steps} env steps, {out['iterations'] * 12} minibatch steps: "
        f"{out['env_steps_per_s']:.1f} env steps/s in the second iteration")
    gen = torch.Generator(rollout["rgb"].device)

    def update():
        trainer.train_phase(rollout, last_obs, gen.manual_seed(0), clip, ent)

    update()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    update()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        update()
        torch.cuda.synchronize()
    total, launches = _log_profile("ppo-train", prof, wall_ms, "one PPO update (values, GAE, 12 minibatch steps)")
    out.update(update_wall_ms=wall_ms, update_device_ms=total, update_launches=launches)
    out["rollout_step_ms"] = _time_rollout_step(torch, trainer.agent, log_dir)
    del trainer, rollout, last_obs
    return out


def _time_rollout_step(torch, agent, log_dir: Path, steps: int = 200) -> dict:
    """Where one rollout step's time goes: the env step (with frame stack),
    the observation's move to the card, and the player's forward and sample
    with the synchronising copies of its action and log-prob; host-clock
    medians over ``steps`` steps."""
    from sheeprl_tpu_torch.algos.ppo.agent import sample_actions
    from sheeprl_tpu_torch.algos.ppo.utils import actions_for_env, prepare_obs, spaces_to_dims
    from sheeprl_tpu_torch.serve.loader import load_run_config
    from sheeprl_tpu_torch.utils.env import make_env, vectorize

    cfg = load_run_config(next(log_dir.glob("**/checkpoint/step_*")))
    envs = vectorize(cfg, [make_env(cfg, 0, 0)])
    dims, cont = spaces_to_dims(envs.single_action_space)
    gen = torch.Generator(next(agent.parameters()).device).manual_seed(0)
    dev = gen.device
    obs, _ = envs.reset(seed=0)
    parts = {"env": [], "obs_to_card": [], "policy": []}
    for _ in range(steps + 10):
        t0 = time.perf_counter()
        o = prepare_obs(obs, ("rgb",), (), dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.inference_mode():
            actions, logprobs, _ = sample_actions(agent(o)[0], dims, cont, gen)
        a, _ = actions.cpu().numpy(), logprobs.cpu().numpy()
        t2 = time.perf_counter()
        obs = envs.step(actions_for_env(a, envs.single_action_space))[0]
        t3 = time.perf_counter()
        for v, dt in zip(parts.values(), (t3 - t2, t1 - t0, t2 - t1)):
            v.append(1e3 * dt)
    envs.close()
    out = {k: statistics.median(v[10:]) for k, v in parts.items()}
    log(f"[ppo-train] one rollout step, host-clock medians of {steps}: env step {out['env']:.3f} ms, observation "
        f"to the card {out['obs_to_card']:.3f} ms, forward + sample + action and log-prob copies "
        f"{out['policy']:.3f} ms")
    return out


def change_diffs(torch, start, params, losses, ref_params, ref_losses) -> dict:
    """A train phase's result against a reference run from the same
    ``start`` weights (the CPU's): the relative L2 difference of the
    parameters' changes, the relative difference of the losses, and
    (reported) the tensor with the largest element difference, that
    difference as a share of the largest change, and how many elements
    differ by a tenth of it."""
    d_ref = torch.cat([(ref_params[k] - start[k]).flatten() for k in ref_params])
    d = torch.cat([(params[k] - start[k]).flatten() for k in ref_params]) - d_ref
    worst = max(ref_params, key=lambda k: float((params[k] - ref_params[k]).abs().max()))
    return {"param_l2": float(d.norm() / d_ref.norm()),
            "loss_rel": float((np.abs(losses - ref_losses) / np.abs(ref_losses)).max()),
            "worst": worst, "worst_share": float(d.abs().max() / d_ref.abs().max()),
            "off_elements": int((d.abs() > 0.1 * d_ref.abs().max()).sum()), "elements": d.numel(),
            "largest_change": float(d_ref.abs().max())}


def within_parity(d: dict) -> bool:
    return d["param_l2"] <= CARD_PARITY_TOL_PARAM and d["loss_rel"] <= CARD_PARITY_TOL_LOSS


def show_diffs(d: dict) -> str:
    return (f"parameter changes rel L2 diff {d['param_l2']:.3g}, losses max rel diff {d['loss_rel']:.3g}; "
            f"largest element diff {d['worst_share']:.3g} of the largest change {d['largest_change']:.3g} (in "
            f"{d['worst']}), {d['off_elements']} of {d['elements']} elements off by more than a tenth of it")


def phase_ppo_parity(torch, snapshot: Path) -> dict:
    """One PPO train phase at phase 16's widths from its snapshot's weights
    on the card and on the CPU, with the same rollout and minibatch orders,
    stepping with SGD (``CARD_PARITY_SGD``); then the card again with
    the SAME pad of the odd stage on the wrong side, which the tolerance
    must catch, and with TF32 on (reported); and both sides with the
    recipe's Adam (reported, not a gate: why the gate steps with SGD)."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer, epoch_permutation, rollout_to_device
    from sheeprl_tpu_torch.algos.ppo.utils import prepare_obs, spaces_to_dims
    from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
    from sheeprl_tpu_torch.fabric import Fabric
    from sheeprl_tpu_torch.serve.loader import load_run_config, probe_spaces
    from sheeprl_tpu_torch.utils.optim import build_optimizer

    cfg = load_run_config(snapshot, ["fabric.accelerator=gpu"])
    saved = load_step_dir(snapshot, map_location="cpu")["agent"]
    obs_space, act_space = probe_spaces(cfg)
    dims, cont = spaces_to_dims(act_space)
    T, B = int(cfg.algo.rollout_steps), int(cfg.env.num_envs)
    rng = np.random.default_rng(17)
    host = {"rgb": rng.integers(0, 256, (T, B, *obs_space["rgb"].shape), dtype=np.uint8),
            "actions": rng.integers(0, dims[0], (T, B, 1)).astype(np.float32),
            "logprobs": (np.log(1.0 / dims[0]) + 0.3 * rng.standard_normal((T, B, 1))).astype(np.float32),
            "rewards": rng.standard_normal((T, B, 1)).astype(np.float32),
            "dones": (rng.random((T, B, 1)) < 0.01).astype(np.float32)}
    last = {"rgb": rng.integers(0, 256, (B, *obs_space["rgb"].shape), dtype=np.uint8)}

    def phase(device: str, pads=None, optim=CARD_PARITY_SGD):
        weights = {k: v.clone() for k, v in saved.items()}  # the CPU agent would train these in place
        agent = build_agent(Fabric(torch.device(device)), dims, cont, cfg, obs_space, weights)
        if pads is not None:
            agent.feature_extractor.cnn_encoder.pads = pads
        optimizer = build_optimizer(agent.parameters(), optim, cfg.algo.max_grad_norm)
        trainer = PPOTrainer(cfg, agent, optimizer, ("rgb",), dims, cont, T, B)
        perms = [epoch_permutation(torch.Generator().manual_seed(e), T, B, trainer.batch_size,
                                   trainer.num_minibatches).to(device) for e in range(trainer.update_epochs)]
        t0 = time.perf_counter()
        losses = trainer.train_phase(rollout_to_device(host, ("rgb",), (), device),
                                     prepare_obs(last, ("rgb",), (), device), perms, 0.1, 0.01)
        if device != "cpu":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return {k: v.detach().cpu() for k, v in agent.state_dict().items()}, np.array([float(x) for x in losses]), seconds

    cpu, cpu_losses, cpu_s = phase("cpu")

    def diffs(params, losses, ref=(cpu, cpu_losses)):
        return change_diffs(torch, saved, params, losses, *ref)

    gpu, gpu_losses, gpu_s = phase(CARD)
    got = diffs(gpu, gpu_losses)
    log(f"[ppo-parity] one train phase (values, GAE, 12 minibatch steps of 256, SGD lr 0.01; CPU {cpu_s:.1f} s, card "
        f"{gpu_s:.2f} s), card vs CPU: {show_diffs(got)}; losses {', '.join(f'{x:.6g}' for x in gpu_losses)} vs "
        f"{', '.join(f'{x:.6g}' for x in cpu_losses)}; tolerance L2 {CARD_PARITY_TOL_PARAM}, losses "
        f"{CARD_PARITY_TOL_LOSS}")
    if not (within_parity(got) and np.isfinite(gpu_losses).all()):
        raise AssertionError("the PPO train phase on the card disagrees with the same phase on the CPU")
    good = build_agent(Fabric(torch.device("cpu")), dims, cont, cfg, obs_space,
                       {k: v.clone() for k, v in saved.items()}).feature_extractor.cnn_encoder.pads
    wrong = [(r, l, b, t) for l, r, t, b in good]  # every stage's low and high pads swapped
    bad = diffs(*phase(CARD, pads=wrong)[:2])
    log(f"[ppo-parity] control, SAME pads on the wrong side ({good} -> {wrong}): {show_diffs(bad)}")
    if within_parity(bad):
        raise AssertionError("the PPO parity tolerance does not catch the SAME pad on the wrong side")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = diffs(*phase(CARD)[:2])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    log(f"[ppo-parity] TF32 on (reported, not a gate): {show_diffs(tf32)}")
    cpu_adam, cpu_adam_losses, _ = phase("cpu", optim=cfg.algo.optimizer)
    adam = diffs(*phase(CARD, optim=cfg.algo.optimizer)[:2], ref=(cpu_adam, cpu_adam_losses))
    log(f"[ppo-parity] the recipe's Adam on both sides (reported, not a gate), card vs CPU: {show_diffs(adam)}")
    return {**got, "cpu_s": cpu_s, "card_s": gpu_s, "wrong_pad": bad, "tf32": tf32, "adam": adam}


def phase_ppo_serve(torch, snapshot: Path) -> dict:
    log(f"[ppo-serve] {snapshot.name} of phase 16")
    served = _drive(torch, snapshot, SERVE_SESSIONS, SERVE_STEPS)
    if any(served["counts"].values()):
        raise AssertionError(f"serving PPO launched kernels: {served['counts']}")
    del served["service"]
    return served


def phase_on_policy_family(torch, run_root: Path) -> dict:
    """A2C at its Atari widths under each RMSprop and recurrent PPO at its
    defaults, 2 iterations each, each snapshot evaluated through ``cli.evaluation``."""
    from sheeprl_tpu_torch.algos.a2c.a2c import A2CTrainer
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import RecurrentPPOTrainer
    from sheeprl_tpu_torch.cli import evaluation

    out = {}
    for name, overrides, trainer_cls in (("a2c_rmsprop", A2C_ATARI, A2CTrainer),
                                         ("a2c_rmsprop_tf", (*A2C_ATARI, *RMSPROP_TF), A2CTrainer),
                                         ("ppo_recurrent", PPO_RECURRENT, RecurrentPPOTrainer)):
        run_ = out[name] = _train_on_policy(torch, overrides, run_root / name, trainer_cls)
        if run_["iterations"] != 2:
            raise AssertionError(f"{name} ran {run_['iterations']} iterations, expected 2")
        t0 = time.perf_counter()
        run_["eval_reward"] = evaluation([f"checkpoint_path={run_['snapshot']}", "fabric.accelerator=gpu"])
        if not np.isfinite(run_["eval_reward"]):
            raise AssertionError(f"cli.evaluation of {name}'s snapshot gave {run_['eval_reward']}")
        log(f"[{name}] cli.evaluation of {run_['snapshot'].name}: cumulative reward {run_['eval_reward']} in "
            f"{time.perf_counter() - t0:.1f} s")
    return out


# -- the off-policy algorithms -----------------------------------------------
def _train_off_policy(torch, overrides, log_dir: Path, trainer_cls, events_only: bool = False) -> dict:
    """One off-policy run through ``cli.run`` with every launch count zeroed
    just before and read just after (none may launch): each update timed
    with the device synchronised around it (with ``events_only``, by CUDA
    events alone: the windows run under ``steady_guard``), and each train
    window's end (a steady iteration is one env step and its window: the
    time between two windows' ends).  Keeps the last window's trainer and
    batches."""
    import csv

    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.ops import gru, rssm

    seconds, ends, kept, events = [], [], {}, []
    update, train_phase = trainer_cls.update, trainer_cls.train_phase

    def timed_update(self, *args, **kwargs):
        if not events_only:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = update(self, *args, **kwargs)
        end.record()
        events.append((start, end))
        if not events_only:
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        return out

    def kept_phase(self, batches, *args, **kwargs):
        out = train_phase(self, batches, *args, **kwargs)
        ends.append(time.perf_counter())
        kept.update(trainer=self, batches=batches)
        return out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rssm.LAUNCHES["rssm"] = gru.LAUNCHES["gru"] = 0
    trainer_cls.update, trainer_cls.train_phase = timed_update, kept_phase
    t0 = time.perf_counter()
    try:
        run([*overrides, f"log_dir={log_dir}"])
    finally:
        trainer_cls.update, trainer_cls.train_phase = update, train_phase
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    event_s = [a.elapsed_time(b) / 1e3 for a, b in events]
    if events_only:
        seconds = event_s
    counts = {"rssm": rssm.LAUNCHES["rssm"], "gru": gru.LAUNCHES["gru"]}
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        raise AssertionError(f"an off-policy run launched kernels: {counts}")
    snapshots = sorted(log_dir.glob("**/checkpoint/step_*"))
    if not snapshots or len(ends) < 2:
        raise AssertionError(f"the run under {log_dir} made {len(ends)} windows and {len(snapshots)} snapshots")
    with open(next(log_dir.glob("**/metrics.csv"))) as f:
        logged = {name: float(value) for _, name, value in list(csv.reader(f))[1:]}
    missing = [n for n in trainer_cls.LOSS_NAMES if n not in logged or not np.isfinite(logged[n])]
    if missing:
        raise AssertionError(f"metrics missing or not finite: {missing}")
    steady = statistics.median(seconds[1:])
    steady_events = statistics.median(event_s[1:])
    iteration = statistics.median(b - a for a, b in zip(ends, ends[1:]))
    out = {"updates": len(seconds), "windows": len(ends), "first_update_s": seconds[0],
           "median_update_s": steady, "updates_per_s": 1.0 / steady, "updates_per_s_events": 1.0 / steady_events,
           "env_steps_per_s": 1.0 / iteration,
           "peak_bytes": peak, "counts": counts, "snapshot": snapshots[-1], "wall_s": wall,
           "logged": {n: logged[n] for n in trainer_cls.LOSS_NAMES}, **kept}
    log(f"[{log_dir.name}] {len(seconds)} updates in {len(ends)} windows, a {wall:.1f} s run: first update "
        f"{seconds[0]:.4f} s, then median {steady * 1e3:.3f} ms = {out['updates_per_s']:.1f} updates/s "
        f"({'CUDA events' if events_only else 'wall'}; by CUDA events {1.0 / steady_events:.1f}); a steady "
        f"iteration (one env step and its window) {iteration * 1e3:.3f} ms = {out['env_steps_per_s']:.1f} env "
        f"steps/s; peak device memory {peak / 2**30:.3f} GiB; launches {counts}")
    log(f"[{log_dir.name}] metrics " + ", ".join(f"{n} {logged[n]:.6g}" for n in trainer_cls.LOSS_NAMES))
    return out


def _profile_update(torch, tag: str, trainer, batches) -> dict:
    """One update of the last window's first batch, unprofiled then under
    the profiler: its wall time, device time, launches and device busy share."""
    from torch.profiler import ProfilerActivity, profile

    one = {k: v[:1] for k, v in batches.items()}
    gen = torch.Generator(one["rewards"].device)

    def update():
        trainer.train_phase(one, gen.manual_seed(0), 0)

    update()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    update()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        update()
        torch.cuda.synchronize()
    total, launches = _log_profile(tag, prof, wall_ms, f"one {tag.split('-')[0]} update")
    return {"update_wall_ms": wall_ms, "update_device_ms": total, "update_launches": launches}


def phase_off_policy_train(torch, run_root: Path) -> dict:
    """Phases 20-22: SAC and DroQ on ``state``, SAC-AE on ``rgb``, at their
    recipes' widths through ``cli.run``; the rates, launches per update and
    a profile of one update each, the snapshot of each evaluated once
    through ``cli.evaluation``."""
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainer
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAETrainer
    from sheeprl_tpu_torch.cli import evaluation

    out = {}
    for name, overrides, trainer_cls, least in (("sac", SAC_STATE, SACTrainer, 300),
                                                ("droq", DROQ_STATE, SACTrainer, 500),
                                                ("sac_ae", SAC_AE_RGB, SACAETrainer, 50)):
        run_ = out[name] = _train_off_policy(torch, overrides, run_root / f"{name}_train", trainer_cls)
        if run_["updates"] < least:
            raise AssertionError(f"{name} ran {run_['updates']} updates, expected at least {least}")
        trainer, batches = run_.pop("trainer"), run_.pop("batches")
        run_.update(_profile_update(torch, f"{name}-train", trainer, batches))
        if name == "sac":  # phase 51 times spans around this update
            run_["kept"] = {"trainer": trainer, "batches": batches}
        t0 = time.perf_counter()
        run_["eval_reward"] = evaluation([f"checkpoint_path={run_['snapshot']}", "fabric.accelerator=gpu"])
        if not np.isfinite(run_["eval_reward"]):
            raise AssertionError(f"cli.evaluation of {name}'s snapshot gave {run_['eval_reward']}")
        log(f"[{name}-train] cli.evaluation of {run_['snapshot'].name}: cumulative reward {run_['eval_reward']} in "
            f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    return out


def _to_device(tree, device):
    """An update's noise (nested dicts and lists of tensors, or None) moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device) if tree is not None else None


def phase_off_policy_parity(torch, snapshots: dict) -> dict:
    """Phase 23: one SAC and one SAC-AE train phase from their snapshots'
    weights on the card and on the CPU, with the same batches and noise,
    stepping every group with SGD (``CARD_PARITY_SGD``); two controls on the
    card that the tolerance must catch (SAC-AE with the decoder's deconv
    kernels left unflipped, SAC with the actor step reading the critic
    before its update); TF32 on and the recipe's Adam reported beside it."""
    import copy

    from sheeprl_tpu_torch.algos.sac.agent import build_agent as sac_agent
    from sheeprl_tpu_torch.algos.sac.agent import ema_update
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainer
    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent as sac_ae_agent
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAETrainer
    from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
    from sheeprl_tpu_torch.fabric import Fabric
    from sheeprl_tpu_torch.serve.loader import load_run_config, probe_spaces

    class StaleCriticSAC(SACTrainer):
        """The control: the actor step reads the critic as it was before this update's critic step."""

        def update(self, batch, noise, step_idx):
            stale = copy.deepcopy(self.critic)
            alpha = torch.exp(self.agent.log_alpha.detach())
            vl = self.critic_step(batch, noise, alpha)
            pl, lp = self.actor_step(batch["obs"], noise, alpha, stale)
            al = self.alpha_step(lp)
            if step_idx % self.target_freq == 0:
                ema_update(self.target_critic, self.critic, self.tau)
            return vl.detach(), pl.detach(), al.detach()

    def unflip(agent):
        with torch.no_grad():
            for m in agent.decoder.decnn.children():
                m.weight.copy_(m.weight.flip(2, 3))

    cases = {"sac": (sac_agent, SACTrainer, StaleCriticSAC, None),
             "sac_ae": (sac_ae_agent, SACAETrainer, SACAETrainer, unflip)}
    out = {}
    for name, (build, trainer_cls, control_cls, control_mutate) in cases.items():
        U, B = OFF_POLICY_PARITY[name]
        cfg = load_run_config(snapshots[name], ["fabric.accelerator=gpu"])
        saved = load_step_dir(snapshots[name], map_location="cpu")["agent"]
        obs_space, act_space = probe_spaces(cfg)
        act_dim = int(np.prod(act_space.shape))
        rng = np.random.default_rng(23)
        host = {"actions": rng.uniform(-0.99, 0.99, (U, B, act_dim)).astype(np.float32),
                "rewards": rng.standard_normal((U, B)).astype(np.float32),
                "terminated": (rng.random((U, B)) < 0.1).astype(np.float32)}
        if name == "sac":
            agent_input = int(sum(np.prod(obs_space[k].shape) for k in cfg.algo.mlp_keys.encoder))
            for k in ("obs", "next_obs"):
                host[k] = rng.standard_normal((U, B, agent_input)).astype(np.float32)
        else:
            agent_input = obs_space
            for k in ("rgb", "next_rgb"):
                host[k] = rng.integers(0, 256, (U, B, *obs_space["rgb"].shape), dtype=np.uint8)
        groups = ("actor", "critic", "alpha", "encoder", "decoder")[:3 if name == "sac" else 5]
        noise_gen = torch.Generator().manual_seed(23)
        probe = trainer_cls(cfg, build(Fabric(torch.device("cpu")), act_dim, cfg, agent_input,
                                       {k: v.clone() for k, v in saved.items()}), {}, act_dim)
        noise = [probe.draw_noise(B, noise_gen) for _ in range(U)]

        def phase(device, cls=trainer_cls, mutate=None, sgd=True):
            run_cfg = copy.deepcopy(cfg)
            if sgd:
                for g in groups:
                    run_cfg.algo[g].optimizer = dict(CARD_PARITY_SGD)
            agent = build(Fabric(torch.device(device)), act_dim, run_cfg, agent_input,
                          {k: v.clone() for k, v in saved.items()})
            if mutate is not None:
                mutate(agent)
            trainer = cls(run_cfg, agent, cls.build_optimizers(run_cfg, agent), act_dim)
            t0 = time.perf_counter()
            losses = trainer.train_phase({k: torch.from_numpy(v).to(device) for k, v in host.items()},
                                         _to_device(noise, device), 0)
            losses = np.array([float(x) for x in losses])
            seconds = time.perf_counter() - t0
            return {k: v.detach().cpu() for k, v in agent.state_dict().items()}, losses, seconds

        cpu, cpu_losses, cpu_s = phase("cpu")
        gpu, gpu_losses, gpu_s = phase(CARD)
        got = change_diffs(torch, saved, gpu, gpu_losses, cpu, cpu_losses)
        log(f"[{name}-parity] one train phase (U {U}, batch {B}, SGD lr {CARD_PARITY_SGD['lr']} for "
            f"{', '.join(groups)}; CPU {cpu_s:.1f} s, card {gpu_s:.2f} s), card vs CPU: {show_diffs(got)}; losses "
            f"{', '.join(f'{x:.6g}' for x in gpu_losses)} vs {', '.join(f'{x:.6g}' for x in cpu_losses)}; tolerance "
            f"L2 {CARD_PARITY_TOL_PARAM}, losses {CARD_PARITY_TOL_LOSS}")
        if not (within_parity(got) and np.isfinite(gpu_losses).all()):
            raise AssertionError(f"the {name} train phase on the card disagrees with the same phase on the CPU")
        what = "the actor step reading the critic before its update" if name == "sac" else \
            "the decoder's deconv kernels left unflipped"
        bad = change_diffs(torch, saved, *phase(CARD, cls=control_cls, mutate=control_mutate)[:2], cpu, cpu_losses)
        log(f"[{name}-parity] control, {what}: {show_diffs(bad)}")
        if within_parity(bad):
            raise AssertionError(f"the {name} parity tolerance does not catch {what}")
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = change_diffs(torch, saved, *phase(CARD)[:2], cpu, cpu_losses)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        log(f"[{name}-parity] TF32 on (reported, not a gate): {show_diffs(tf32)}")
        cpu_adam, cpu_adam_losses, _ = phase("cpu", sgd=False)
        adam = change_diffs(torch, saved, *phase(CARD, sgd=False)[:2], cpu_adam, cpu_adam_losses)
        log(f"[{name}-parity] the recipe's Adam on both sides (reported, not a gate), card vs CPU: {show_diffs(adam)}")
        out[name] = {**got, "cpu_s": cpu_s, "card_s": gpu_s, "control": bad, "tf32": tf32, "adam": adam}
    return out


def phase_sac_serve(torch, snapshot: Path) -> dict:
    log(f"[sac-serve] {snapshot.name} of phase 20")
    served = _drive(torch, snapshot, SERVE_SESSIONS, SERVE_STEPS)
    if any(served["counts"].values()):
        raise AssertionError(f"serving SAC launched kernels: {served['counts']}")
    del served["service"]
    return served


def phase_off_policy(torch, run_root: Path) -> dict:
    """Phases 20-24."""
    train = phase_off_policy_train(torch, run_root)
    parity = phase_off_policy_parity(torch, {name: train[name]["snapshot"] for name in ("sac", "sac_ae")})
    served = phase_sac_serve(torch, train["sac"]["snapshot"])
    return {"train": train, "parity": parity, "serve": served}


# -- the decoupled recipes (phases 68-69) --------------------------------------
# PPO's recipe on the dummy env's state (4 envs x 128 steps, 10 epochs of 8
# minibatches), 3 iterations; its decoupled twin the same
PPO_COUPLED = ("exp=ppo", *ON_POLICY, "algo.run_test=False", "algo.total_steps=1536")
PPO_DECOUPLED = ("exp=ppo_decoupled", *PPO_COUPLED[1:])
DECOUPLED_TURNS = ("decoupled", "coupled")
# the card-vs-CPU gate: 3 iterations of 32 steps x 4 envs, SGD, the same draws
PPO_DECOUPLED_PARITY = ("exp=ppo_decoupled", *(o for o in ON_POLICY if o != "fabric.accelerator=gpu"),
                        "algo.run_test=False", "algo.rollout_steps=32", "algo.total_steps=384",
                        *(f"algo.optimizer.{k}={v}" for k, v in CARD_PARITY_SGD.items()))
# SAC's recipe on the continuous dummy env: a prefill of 100 steps, 200 in all
SAC_COUPLED = ("exp=sac", *OFF_POLICY, HOST_RING, "algo.learning_starts=100", "algo.total_steps=200")
SAC_DECOUPLED = ("exp=sac_decoupled", *SAC_COUPLED[1:])


def _decoupled_staleness(torch, module) -> dict:
    """Spies on the decoupled PPO loop of ``module``: the player's weights at
    each rollout and the trained weights after each update."""
    import copy

    seen = {"rollouts": [], "trained": [], "holder": {}}

    def flat(m):
        return torch.cat([p.detach().flatten() for p in m.parameters()]).clone()

    def deepcopy(m):
        seen["holder"]["player"] = copy.deepcopy(m)
        seen["holder"]["agent"] = m
        return seen["holder"]["player"]

    rollout = module.host_rollout

    def host_rollout(*args):
        seen["rollouts"].append(flat(seen["holder"]["player"]))
        return rollout(*args)

    def trained():
        seen["trained"].append(flat(seen["holder"]["agent"]))

    return seen, {"copy": types.SimpleNamespace(deepcopy=deepcopy), "host_rollout": host_rollout}, trained


def phase_ppo_decoupled(torch, run_root: Path) -> dict:
    """Phase 68: ``exp=ppo_decoupled`` through ``cli.run`` at PPO's recipe
    widths in turns with ``exp=ppo`` (:data:`DECOUPLED_TURNS`): env
    steps/s and iterations/s; in the first decoupled run, the player's
    weights at every rollout: rollout k+1 acted with the weights trained on
    rollout k-1 (the first two with the initial ones), never aliasing them;
    then 3 iterations on the card against the CPU with SGD and the same
    draws (each step's action noise and each epoch's minibatch order made on
    the CPU), :func:`change_diffs` within phase 17's tolerances."""
    from sheeprl_tpu_torch.algos.ppo import ppo_decoupled
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer

    t0 = time.perf_counter()
    runs = {"decoupled": [], "coupled": []}
    staleness = None
    for i, name in enumerate(DECOUPLED_TURNS):
        recipe = PPO_DECOUPLED if name == "decoupled" else PPO_COUPLED
        patches, trained = {}, None
        if i == 0:
            seen, patches, trained = _decoupled_staleness(torch, ppo_decoupled)
        saved = {k: getattr(ppo_decoupled, k) for k in patches}
        train_phase = PPOTrainer.train_phase

        def spied(self, *args, **kwargs):
            out = train_phase(self, *args, **kwargs)
            if trained is not None:
                trained()
            return out

        for k, v in patches.items():
            setattr(ppo_decoupled, k, v)
        PPOTrainer.train_phase = spied
        try:
            run_ = _train_on_policy(torch, recipe, run_root / f"ppo_{name}_{i}", PPOTrainer)
        finally:
            PPOTrainer.train_phase = train_phase
            for k, v in saved.items():
                setattr(ppo_decoupled, k, v)
        run_["env_steps_per_s"] = 4 * 128 * run_["iterations_per_s"]  # the recipe's env.num_envs x rollout_steps
        runs[name].append(run_)
        if i == 0:
            rollouts, after = seen["rollouts"], seen["trained"]
            init = rollouts[0]
            stale = [torch.equal(rollouts[k], init if k < 2 else after[k - 2]) for k in range(len(rollouts))]
            current = [torch.equal(rollouts[k], after[k - 1]) for k in range(2, len(rollouts))]
            holder = seen["holder"]
            aliased = bool({p.data_ptr() for p in holder["agent"].parameters()}
                           & {p.data_ptr() for p in holder["player"].parameters()})
            staleness = {"rollouts": len(rollouts), "updates": len(after), "stale": stale, "current": current,
                         "aliased": aliased}
            log(f"[ppo-decoupled] {len(rollouts)} rollouts and {len(after)} updates: rollout k+1 acted with the "
                f"weights of update k-1 {sum(stale)} of {len(stale)}, with the current weights {sum(current)} of "
                f"{len(current)}; player aliases the trained tensors {aliased}")
            del seen
    ups = {k: [r["iterations_per_s"] for r in v] for k, v in runs.items()}
    steps = {k: [r["env_steps_per_s"] for r in v] for k, v in runs.items()}
    log(f"[ppo-decoupled] turns {', '.join(DECOUPLED_TURNS)}: iterations/s decoupled "
        f"{', '.join(f'{x:.3f}' for x in ups['decoupled'])}, coupled {', '.join(f'{x:.3f}' for x in ups['coupled'])}; "
        f"env steps/s decoupled {', '.join(f'{x:.1f}' for x in steps['decoupled'])}, coupled "
        f"{', '.join(f'{x:.1f}' for x in steps['coupled'])}")
    parity = _ppo_decoupled_parity(torch, run_root)
    out = {"iterations_per_s": ups, "env_steps_per_s": steps, "staleness": staleness, "parity": parity,
           "counts": {k: sum(r["counts"][k] for v in runs.values() for r in v) for k in ("rssm", "gru")},
           "seconds": time.perf_counter() - t0}
    log(f"[ppo-decoupled] phase 68: {out['seconds']:.1f} s")
    if not (all(staleness["stale"]) and not any(staleness["current"]) and not staleness["aliased"]
            and staleness["rollouts"] == staleness["updates"] >= 3 and within_parity(parity)):
        raise AssertionError(f"[ppo-decoupled] failed: staleness {staleness}, card vs CPU {parity}")
    return out


def _ppo_decoupled_parity(torch, run_root: Path) -> dict:
    """Phase 68's gate: :data:`PPO_DECOUPLED_PARITY` through ``cli.run`` on
    the CPU and on the card from the CPU run's initial weights, every action
    draw and minibatch order made on the CPU and handed to both."""
    from sheeprl_tpu_torch.algos.ppo import ppo_decoupled
    from sheeprl_tpu_torch.algos.ppo.agent import action_noise
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer, epoch_permutation
    from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
    from sheeprl_tpu_torch.cli import run

    weights = {}

    def side(device: str) -> tuple:
        sample, train_phase, build = ppo_decoupled.sample_actions, PPOTrainer.train_phase, ppo_decoupled.build_agent
        draws, orders, state = torch.Generator().manual_seed(68), torch.Generator().manual_seed(69), {}

        def build_agent(fabric, dims, cont, cfg, obs_space, saved=None):
            # the card starts from the CPU's initial weights (the recipe's init draws on its device)
            agent = build(fabric, dims, cont, cfg, obs_space, weights.get("start"))
            weights.setdefault("start", {k: v.detach().cpu().clone() for k, v in agent.state_dict().items()})
            return agent

        def sample_actions(out, dims, cont, noise=None, greedy=False, dist_type="auto"):
            cpu = action_noise(out.detach().cpu(), dims, cont, dist_type, draws)
            return sample(out, dims, cont, [n.to(out.device) for n in cpu], greedy, dist_type)

        def phase(self, rollout, last_obs, perms, clip, ent):
            state.setdefault("start", {k: v.detach().cpu().clone() for k, v in self.agent.state_dict().items()})
            perms = [epoch_permutation(orders, self.T, self.B, self.batch_size, self.num_minibatches).to(device)
                     for _ in range(self.update_epochs)]
            losses = train_phase(self, rollout, last_obs, perms, clip, ent)
            state["losses"] = np.array([float(x) for x in losses])
            return losses

        ppo_decoupled.sample_actions, PPOTrainer.train_phase, ppo_decoupled.build_agent = sample_actions, phase, \
            build_agent
        log_dir = run_root / f"ppo_decoupled_parity_{device}"
        t = time.perf_counter()
        try:
            run([*PPO_DECOUPLED_PARITY, f"fabric.accelerator={'cpu' if device == 'cpu' else 'gpu'}",
                 f"log_dir={log_dir}"])
        finally:
            ppo_decoupled.sample_actions, PPOTrainer.train_phase, ppo_decoupled.build_agent = sample, train_phase, build
        snapshot = sorted(log_dir.glob("**/checkpoint/step_*"))[-1]
        params = {k: v.cpu() for k, v in load_step_dir(snapshot, map_location="cpu")["agent"].items()}
        return state["start"], params, state["losses"], time.perf_counter() - t

    cpu_start, cpu, cpu_losses, cpu_s = side("cpu")
    card_start, card, card_losses, card_s = side(CARD)
    same_start = all(torch.equal(card_start[k], cpu_start[k]) for k in cpu_start)
    got = change_diffs(torch, cpu_start, card, card_losses, cpu, cpu_losses)
    log(f"[ppo-decoupled] 3 decoupled iterations of 32 x 4 steps with SGD, card ({card_s:.1f} s) vs CPU "
        f"({cpu_s:.1f} s) from the same initial weights {same_start} and draws: {show_diffs(got)}")
    if not same_start:
        raise AssertionError("[ppo-decoupled] the card and the CPU started from different weights")
    return got


def phase_sac_decoupled(torch, run_root: Path) -> dict:
    """Phase 69: ``exp=sac_decoupled`` through ``cli.run`` in turns with
    ``exp=sac`` (:data:`DECOUPLED_TURNS`) at SAC's recipe
    widths: updates/s, and ``Player/param_staleness_max`` of each decoupled
    run, at most ``algo.player.sync_every`` + 1 (the deferred refresh lands
    one window late)."""
    import csv

    from sheeprl_tpu_torch.algos.sac.sac import SACTrainer
    from sheeprl_tpu_torch.config.compose import compose

    t0 = time.perf_counter()
    sync_every = int(compose(list(SAC_DECOUPLED)).algo.player.sync_every)
    runs = {"decoupled": [], "coupled": []}
    stale = []
    for i, name in enumerate(DECOUPLED_TURNS):
        log_dir = run_root / f"sac_{name}_{i}"
        run_ = _train_off_policy(torch, SAC_DECOUPLED if name == "decoupled" else SAC_COUPLED, log_dir, SACTrainer)
        run_.pop("trainer"), run_.pop("batches")
        runs[name].append(run_)
        if name == "decoupled":
            with open(next(log_dir.glob("**/metrics.csv"))) as f:
                stale.append(max(float(v) for _, n, v in list(csv.reader(f))[1:]
                                 if n == "Player/param_staleness_max"))
    ups = {k: [r["updates_per_s"] for r in v] for k, v in runs.items()}
    out = {"updates_per_s": ups, "staleness_max": stale, "sync_every": sync_every,
           "counts": {k: sum(r["counts"][k] for v in runs.values() for r in v) for k in ("rssm", "gru")},
           "seconds": time.perf_counter() - t0}
    log(f"[sac-decoupled] turns {', '.join(DECOUPLED_TURNS)}: updates/s decoupled "
        f"{', '.join(f'{x:.1f}' for x in ups['decoupled'])}, coupled {', '.join(f'{x:.1f}' for x in ups['coupled'])}; "
        f"Player/param_staleness_max {stale} at sync_every {sync_every}; phase 69: {out['seconds']:.1f} s")
    if not (stale and all(0 < s <= sync_every + 1 for s in stale)):
        raise AssertionError(f"[sac-decoupled] staleness {stale} not within 1..{sync_every + 1}")
    return out


def phase_decoupled(torch, run_root: Path) -> dict:
    """Phases 68-69."""
    return {"ppo": phase_ppo_decoupled(torch, run_root), "sac": phase_sac_decoupled(torch, run_root)}


# -- the env layer: device envs, Anakin rollouts, the host wrappers ------------
# Phase 25 steps each device env on the card and on the CPU from one state
# with one set of actions and reset draws, teacher-forced from the CPU state
# at every step: integer and boolean leaves, flags and uint8 frames must be
# equal, and a float leaf, observation or reward may differ by ENV_FLOAT_LIMIT
# (one step of fp32 arithmetic whose sin / cos and fused multiply-adds differ
# by ulps between the two devices; values stay within a few hundred).
ENV_PARITY_STEPS, ENV_PARITY_ROWS, ENV_PARITY_LIMIT_STEPS = 256, 64, 100
ENV_FLOAT_LIMIT = 1e-4
ENVS_COMMON = ("fabric.accelerator=gpu", "metric/logger=csv", "checkpoint.save_last=True",
               "checkpoint.every=1000000000", "checkpoint.async_save=False", "buffer.memmap=False", "seed=5",
               "algo.run_test=False")
# PPO's recipe (MLP 64 x 2, rollout 128, 10 epochs) at the fused instance
# count of 1024 envs: a batch of 16384 keeps the recipe's 8 minibatches of
# the rollout per epoch; 3 iterations (the first is warm-up)
ANAKIN_PPO = ("exp=ppo", "env=jax_cartpole", *ENVS_COMMON, "env.num_envs=1024", "algo.per_rank_batch_size=16384",
              "algo.total_steps=393216")
# the same recipe through the adapter at 16 host-stepped envs, 2 iterations
ADAPTER_PPO = ("exp=ppo", "env=jax_cartpole", *ENVS_COMMON, "algo.anakin=False", "env.num_envs=16",
               "algo.total_steps=4096")
# PPO through the CNN on forage's 64x64 frames, 128 envs (an 0.8 GB rollout;
# 256 until the deployment phases needed the time), the recipe's 10 epochs
# of 8 minibatches; 2 iterations
ANAKIN_FORAGE = ("exp=ppo", "env=jax_forage", *ENVS_COMMON, "env.num_envs=128", "algo.cnn_keys.encoder=[rgb]",
                 "algo.mlp_keys.encoder=[]", "algo.per_rank_batch_size=2048", "algo.total_steps=32768")
ANAKIN_A2C = ("exp=a2c", "env=jax_cartpole", *ENVS_COMMON, "env.num_envs=1024", "algo.total_steps=262144")
# recurrent PPO at its defaults, 32 envs in one minibatch of 32 env columns
# (64 envs in two until the deployment phases needed the time); 2 iterations
ANAKIN_RECURRENT = ("exp=ppo_recurrent", "env=jax_cartpole", *ENVS_COMMON, "env.mask_velocities=False",
                    "env.num_envs=32", "algo.per_rank_batch_size=4096", "algo.total_steps=8192")
# phase 7's XL recipe on forage (rgb alone), the fused kernel; replay ratio
# 1/16: int(65 / 16) = 4 updates at step 65, one chunk
DV3_FORAGE = (*(o for o in XL_TRAIN if not o.startswith(("env=", "env.id=", "algo.mlp_keys"))), "env=jax_forage",
              "algo.mlp_keys.encoder=[]", FUSED, "algo.replay_ratio=0.0625", "algo.total_steps=65",
              "algo.run_test=False")
# ppo_atari's recipe at Atari's input: forage resized to 84x84, gray, 4 frames; 2 iterations of 1024 steps
PPO_ATARI_FORAGE = ("exp=ppo_atari", "env=jax_forage", *ENVS_COMMON, "env.screen_size=84", "env.grayscale=True",
                    "env.frame_stack=4", "env.num_envs=1", "algo.anakin=False", "algo.total_steps=2048")
# SAC's recipe on its pendulum: a prefill of 100 random steps, then 200 more, one update each
SAC_PENDULUM = ("exp=sac", "env=jax_pendulum", *ENVS_COMMON, "buffer.checkpoint=False", "env.num_envs=1",
                "algo.learning_starts=100", "algo.total_steps=300")

# -- the Sebulba actor/learner split, both roles on the card (phases 70-72) -----
# phase 68's recipe (PPO's widths on the dummy env's state, 4 envs x 128 steps,
# 3 iterations) with 2 env workers; its fault drill 2 iterations with a crash
SEBULBA_PPO = (*PPO_DECOUPLED, "topology=sebulba", "topology.env_workers=2")
SEBULBA_PPO_DRILL = (*SEBULBA_PPO, "algo.total_steps=512")
# phase 70's card-vs-CPU gate steps 2 of the recipe's 10 epochs: with its
# unclipped SGD on the dummy state (values up to 31) 10 epochs amplify a
# 1e-7 weight perturbation to 0.05-0.19 rel L2 on the CPU alone, 2 epochs to
# 8.8e-06-8.9e-06 (tools/sebulba_sensitivity.py); the tolerance is phase 68's
SEBULBA_PARITY_EPOCHS = 2
SEBULBA_PPO_FAULT = {"site": "sebulba.env_worker", "kind": "raise", "at": 40, "max_fires": 1}
# phase 26's Anakin recipe (1024 jax_cartpole envs x 128 steps), decoupled, the
# fused actor under the transfer guard; 3 iterations
SEBULBA_FUSED = ("exp=ppo_decoupled", *ANAKIN_PPO[1:], "topology=sebulba", "topology.actor_devices=1",
                 "buffer.transfer_guard=True")
# phase 69's recipe on the card's ring: one env, so one worker
SEBULBA_SAC = (*SAC_DECOUPLED, "topology=sebulba", "topology.env_workers=1", "buffer.device=True")


def _sebulba_run(torch, module, overrides, log_dir: Path, plan: dict = None, spy_learner: bool = False,
                 spy_fused: bool = False) -> dict:
    """One Sebulba run through ``cli.run`` with the launch counts zeroed just
    before and read just after (none may launch): its stats, and with
    ``spy_learner`` the first learner phase's segments (the queued tensors
    themselves) and starting weights, with ``spy_fused`` the fused actor, its
    carry, generator states and weights as its first window found them."""
    import copy

    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.ops import gru, rssm
    from sheeprl_tpu_torch.resilience.faults import ENV_VAR, FaultPlan
    from sheeprl_tpu_torch.sebulba import actor as sactor
    from sheeprl_tpu_torch.sebulba import ppo as sppo

    seen = {}
    saved = {"collect_run_stats": module.collect_run_stats}

    def stats_spy(**kw):
        seen["stats"] = saved["collect_run_stats"](**kw)
        return seen["stats"]

    module.collect_run_stats = stats_spy
    if spy_learner:
        saved["make_learner_phase"] = sppo.make_learner_phase

        def make_learner_phase(trainer, obs_keys):
            phase = saved["make_learner_phase"](trainer, obs_keys)

            def first(segs, *args):
                if "segs" not in seen:
                    seen["segs"] = list(segs)
                    seen["start"] = {k: v.detach().cpu().clone() for k, v in trainer.agent.state_dict().items()}
                    seen["trainer"] = trainer
                return phase(segs, *args)

            return first

        sppo.make_learner_phase = make_learner_phase
    warmup = sactor.FusedActor.warmup
    if spy_fused:
        def warm(self):
            warmup(self)
            seen["fused"] = {"actor": self, "carry": copy.deepcopy(self._carry),
                             "generators": [g.get_state() for g in self.generators],
                             "weights": {k: v.clone() for k, v in self._live.items()}}

        sactor.FusedActor.warmup = warm
    if plan is not None:
        os.environ[ENV_VAR] = FaultPlan.from_specs([plan]).to_json()
    gc.collect()
    torch.cuda.empty_cache()
    rssm.LAUNCHES["rssm"] = gru.LAUNCHES["gru"] = 0
    t0 = time.perf_counter()
    try:
        run([*overrides, f"log_dir={log_dir}"])
    finally:
        os.environ.pop(ENV_VAR, None)
        module.collect_run_stats = saved["collect_run_stats"]
        if spy_learner:
            sppo.make_learner_phase = saved["make_learner_phase"]
        sactor.FusedActor.warmup = warmup
    counts = {"rssm": rssm.LAUNCHES["rssm"], "gru": gru.LAUNCHES["gru"]}
    stats = seen["stats"]
    stats.pop("phase_breakdown", None)
    cfg = compose(list(overrides))
    per_iter = int(cfg.env.num_envs) * int(cfg.algo.get("rollout_steps") or cfg.topology.segment_steps)
    seen.update(stats=stats, counts=counts, wall_s=time.perf_counter() - t0, cfg=cfg,
                iterations=int(cfg.algo.total_steps) // per_iter, env_steps=int(cfg.algo.total_steps) // per_iter
                * per_iter)
    log(f"[{log_dir.name}] {json.dumps(stats, default=str)}; launches {counts}; run {seen['wall_s']:.1f} s")
    if any(counts.values()):
        raise AssertionError(f"a Sebulba run launched kernels: {counts}")
    return seen


def _sebulba_gates(run_: dict, where: str) -> None:
    """Phase 70's and 71's gates: one update per iteration and every env step
    consumed, nothing torn, one program per actor graph, the staleness bounds."""
    s, topo = run_["stats"], run_["cfg"].topology
    bad = []
    if s["updates"] != run_["iterations"] or s["env_steps"] != run_["env_steps"]:
        bad.append(f"updates {s['updates']} / env steps {s['env_steps']}, wanted {run_['iterations']} / "
                   f"{run_['env_steps']}")
    if s["torn_rejected"]:
        bad.append(f"{s['torn_rejected']} torn segments")
    if not all(v == 1 for sizes in s["actor_cache_sizes"] for v in sizes.values()):
        bad.append(f"actor programs {s['actor_cache_sizes']}")
    if s["param_staleness_max"] > int(topo.max_staleness) + 1:
        bad.append(f"param staleness {s['param_staleness_max']}")
    if s["traj_staleness_max"] > int(topo.max_staleness) + int(topo.traj_queue_slots):
        bad.append(f"trajectory staleness {s['traj_staleness_max']}")
    if bad:
        raise AssertionError(f"[{where}] " + "; ".join(bad))


def _sebulba_learner_parity(torch, seen: dict) -> dict:
    """Phase 70's gate: the learner phase on the run's first consumed segments
    from its starting weights, on the card and on the CPU, stepped with SGD
    for :data:`SEBULBA_PARITY_EPOCHS` epochs under the recipe's gradient clip
    and coefficients, the minibatch orders made on the CPU and handed to
    both."""
    import copy

    from sheeprl_tpu_torch.algos.ppo.ppo import epoch_permutation
    from sheeprl_tpu_torch.sebulba.ppo import make_learner_phase
    from sheeprl_tpu_torch.utils.optim import build_optimizer

    src, cfg = seen["trainer"], seen["cfg"]
    segs = [{k: v.detach().cpu().clone() for k, v in s.items()} for s in seen["segs"]]
    orders = torch.Generator().manual_seed(70)
    perms = [epoch_permutation(orders, src.T, src.B, src.batch_size, src.num_minibatches)
             for _ in range(SEBULBA_PARITY_EPOCHS)]
    results = {}
    for device in ("cpu", CARD):
        agent = copy.deepcopy(src.agent).to(device)
        agent.load_state_dict(seen["start"])
        trainer = copy.copy(src)
        trainer.agent, trainer.update_epochs = agent, SEBULBA_PARITY_EPOCHS
        trainer.optimizer = build_optimizer(agent.named_parameters(), dict(CARD_PARITY_SGD), cfg.algo.max_grad_norm)
        losses = make_learner_phase(trainer, src.obs_keys)([{k: v.to(device) for k, v in s.items()} for s in segs],
                                                           [p.to(device) for p in perms], float(cfg.algo.clip_coef),
                                                           float(cfg.algo.ent_coef))
        results[device] = ({k: v.detach().cpu() for k, v in agent.state_dict().items()},
                           np.array([float(x) for x in losses]))
    got = change_diffs(torch, seen["start"], results[CARD][0], results[CARD][1], results["cpu"][0],
                       results["cpu"][1])
    log(f"[sebulba-ppo] the learner phase on the first consumed segments with SGD, card vs CPU: {show_diffs(got)}")
    return got


def phase_sebulba_ppo(torch, run_root: Path, beside: dict = None) -> dict:
    """Phase 70: ``exp=ppo_decoupled topology=sebulba`` through ``cli.run``,
    host envs in 2 worker threads, both roles on the card: the counters, the
    torn-segment count, one captured graph per rung, the staleness bounds;
    then a run with a planted ``sebulba.env_worker`` crash (a worker
    respawned, every env step, nothing torn); the learner phase card vs CPU
    with SGD.  Env steps/s beside phase 68's."""
    from sheeprl_tpu_torch.sebulba import ppo as sppo

    t0 = time.perf_counter()
    main = _sebulba_run(torch, sppo, SEBULBA_PPO, run_root / "sebulba_ppo", spy_learner=True)
    _sebulba_gates(main, "sebulba-ppo")
    parity = _sebulba_learner_parity(torch, main)
    drill = _sebulba_run(torch, sppo, SEBULBA_PPO_DRILL, run_root / "sebulba_ppo_fault", plan=SEBULBA_PPO_FAULT)
    ds = drill["stats"]
    if not (ds["worker_restarts"] >= 1 and ds["env_steps"] == drill["env_steps"] and ds["torn_rejected"] == 0):
        raise AssertionError(f"[sebulba-ppo] the crash drill: {ds}")
    s = main["stats"]
    out = {"stats": s, "drill": ds, "parity": parity, "counts": main["counts"],
           "env_steps_per_s": s["env_steps_per_s"], "seconds": time.perf_counter() - t0}
    beside = beside or {}
    log(f"[sebulba-ppo] phase 70: {s['env_steps_per_s']:.1f} env steps/s (actor idle "
        f"{s['actor_idle_frac']:.3f}, queue depth {s['queue_depth_frac']:.3f}) beside phase 68's decoupled "
        f"{beside.get('decoupled', 'not measured in this run')} and coupled "
        f"{beside.get('coupled', 'not measured in this run')}; drill restarts {ds['worker_restarts']}; "
        f"{out['seconds']:.1f} s")
    if not within_parity(parity):
        raise AssertionError(f"[sebulba-ppo] card vs CPU {parity}")
    return out


def phase_sebulba_fused(torch, run_root: Path, beside: float = None) -> dict:
    """Phase 71: the fused device-env actor at phase 26's 1024 envs x 128
    steps under ``buffer.transfer_guard``: one captured rollout graph, the
    staleness bounds, and the first queued segment equal bit for bit to an
    eager rollout from the carry, generator states and weights its window
    started from (compared after the run: a segment queued without a copy
    would hold a later replay's numbers).  Env steps/s beside phase 26's."""
    from sheeprl_tpu_torch.sebulba import ppo as sppo

    t0 = time.perf_counter()
    run_ = _sebulba_run(torch, sppo, SEBULBA_FUSED, run_root / "sebulba_fused", spy_learner=True, spy_fused=True)
    _sebulba_gates(run_, "sebulba-fused")
    fused = run_["fused"]
    actor = fused["actor"]
    with torch.no_grad():
        for k, v in actor._live.items():
            v.copy_(fused["weights"][k])
    for g, s in zip(actor.generators, fused["generators"]):
        g.set_state(s)
    _, traj, last_obs, _ = actor.rollout.compiled._fn(fused["carry"], None, None)
    eager = {**traj, **{f"last_{k}": v for k, v in last_obs.items()}}
    first = run_["segs"][0]
    equal = {k: bool(torch.equal(first[k], eager[k])) for k in eager}
    s = run_["stats"]
    out = {"stats": s, "first_segment_equal": equal, "counts": run_["counts"],
           "env_steps_per_s": s["env_steps_per_s"], "seconds": time.perf_counter() - t0}
    log(f"[sebulba-fused] phase 71: {s['env_steps_per_s']:.1f} env steps/s (actor idle {s['actor_idle_frac']:.3f}) "
        f"beside phase 26's coupled Anakin PPO {beside if beside is not None else 'not measured in this run'}; the "
        f"first queued segment equals the eager rollout in {sum(equal.values())} of {len(equal)} leaves; "
        f"{out['seconds']:.1f} s")
    if not all(equal.values()):
        raise AssertionError(f"[sebulba-fused] first segment against the eager rollout: {equal}")
    return out


def phase_sebulba_sac(torch, run_root: Path, beside: float = None) -> dict:
    """Phase 72: ``exp=sac_decoupled topology=sebulba buffer.device=True`` at
    phase 69's recipe: updates, the exact env steps, nothing torn; gradient
    updates/s beside phase 69's decoupled SAC."""
    from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
    from sheeprl_tpu_torch.sebulba import sac as ssac

    t0 = time.perf_counter()
    log_dir = run_root / "sebulba_sac"
    run_ = _sebulba_run(torch, ssac, SEBULBA_SAC, log_dir)
    s = run_["stats"]
    grad_steps = int(load_step_dir(sorted(log_dir.glob("**/checkpoint/step_*"))[-1], map_location="cpu")["grad_steps"])
    out = {"stats": s, "grad_steps": grad_steps, "updates_per_s": grad_steps / s["wall_s"], "counts": run_["counts"],
           "seconds": time.perf_counter() - t0}
    log(f"[sebulba-sac] phase 72: {s['updates']} windows, {grad_steps} gradient updates = "
        f"{out['updates_per_s']:.1f} updates/s beside phase 69's decoupled SAC "
        f"{beside if beside is not None else 'not measured in this run'}; {out['seconds']:.1f} s")
    if not (s["updates"] > 0 and s["env_steps"] == run_["env_steps"] and s["torn_rejected"] == 0):
        raise AssertionError(f"[sebulba-sac] {s}")
    return out


def phase_sebulba(torch, run_root: Path, decoupled: dict = None, anakin: float = None) -> dict:
    """Phases 70-72; ``decoupled`` (phases 68-69) and ``anakin`` (phase 26's
    env steps/s) give the numbers they are reported beside."""
    ppo68 = {k: f"{statistics.median(v):.1f}" for k, v in decoupled["ppo"]["env_steps_per_s"].items()} \
        if decoupled else None
    sac69 = f"{statistics.median(decoupled['sac']['updates_per_s']['decoupled']):.1f}" if decoupled else None
    return {"ppo": phase_sebulba_ppo(torch, run_root, ppo68),
            "fused": phase_sebulba_fused(torch, run_root, f"{anakin:.1f}" if anakin is not None else None),
            "sac": phase_sebulba_sac(torch, run_root, sac69)}



def phase_env_parity(torch) -> dict:
    """Phase 25: each device env on the card against the CPU, teacher-forced."""
    from sheeprl_tpu_torch.envs.device import VectorDeviceEnv, make_device_env

    def to(tree, dev):
        return type(tree)(*(v.to(dev) for v in tree)) if hasattr(tree, "_fields") else \
            {k: v.to(dev) for k, v in tree.items()}

    def compare(got, want, what, worst):
        for k, w in (want._asdict() if hasattr(want, "_fields") else want).items():
            g = (got._asdict() if hasattr(got, "_fields") else got)[k].cpu()
            if w.is_floating_point():
                worst = max(worst, float((g - w).abs().max()))
            elif not torch.equal(g, w):
                raise AssertionError(f"{what}.{k}: the card and the CPU disagree on {int((g != w).sum())} entries")
        return worst

    out = {}
    for name in ("cartpole", "pendulum", "forage", "multiroom"):
        env = make_device_env(name, max_episode_steps=ENV_PARITY_LIMIT_STEPS)
        n = ENV_PARITY_ROWS
        cpu = VectorDeviceEnv(env, n, "cpu", torch.Generator().manual_seed(0))
        card = VectorDeviceEnv(env, n, CARD, torch.Generator(CARD).manual_seed(0))
        state, _ = cpu.reset()
        if "level" in state._fields:
            state = state._replace(level=torch.linspace(0.0, 2.5 if name == "multiroom" else 1.0, n))
        rng = np.random.default_rng(0)
        worst, ends = 0.0, 0
        t0 = time.perf_counter()
        for t in range(ENV_PARITY_STEPS):
            if name == "pendulum":
                actions = torch.from_numpy(rng.uniform(-2.5, 2.5, (n, 1)).astype(np.float32))
            else:
                actions = torch.from_numpy(rng.integers(0, env.action_space.n, n))
            draws = env.draw_reset(n, cpu.generator, "cpu")
            want = cpu.step(state, actions, draws)
            got = card.step(to(state, CARD), actions.to(CARD), to(draws, CARD))
            what = f"{name} step {t}"
            for i, part in enumerate(("state", "obs", "reward", "terminated", "truncated", "final_obs")):
                if isinstance(want[i], torch.Tensor):
                    worst = compare({part: got[i]}, {part: want[i]}, what, worst)
                else:
                    worst = compare(got[i], want[i], f"{what} {part}", worst)
            ends += int((want[3] | want[4]).sum())
            state = want[0]
        torch.cuda.synchronize()
        if worst > ENV_FLOAT_LIMIT:
            raise AssertionError(f"{name}: the card's floats differ from the CPU's by {worst:.3g} > {ENV_FLOAT_LIMIT}")
        out[name] = {"max_float_diff": worst, "episode_ends": ends}
        log(f"[env-parity] {name}: {ENV_PARITY_STEPS} steps x {n} envs, card vs CPU teacher-forced: integers, flags "
            f"and frames equal, largest float difference {worst:.3g} (limit {ENV_FLOAT_LIMIT:g}); {ends} episode ends "
            f"and resets; {time.perf_counter() - t0:.1f} s")
    return out


def _instrument_rollouts(torch, module, attr: str) -> dict:
    """Record the rollout length ``module.<attr>`` (an Anakin rollout
    factory) is built with, and time every call of the loop's rollout route
    (``fabric.compile``'s ``<algo>.rollout``: one captured CUDA graph for
    PPO on the card, eager for A2C and recurrent PPO) with the device
    synchronised around it, under ``torch.cuda.set_sync_debug_mode("error")``:
    any call inside its T steps that makes the host wait for the device
    raises (the first call's capture included).  Returns the record the
    calls fill (the last call's route and arguments among it); ``undo``
    restores the module and the route."""
    from sheeprl_tpu_torch.parallel.compile import GraphFunction

    rec = {"ms": [], "gated": 0, "steps": None, "last": None, "graphs": []}
    make = getattr(module, attr)
    call = GraphFunction.__call__

    def make_recording(*args, **kwargs):
        rec["steps"] = int(kwargs["rollout_steps"])
        return make(*args, **kwargs)

    def timed(self, *a, **k):
        if not self.name.endswith(".rollout"):
            return call(self, *a, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            result = call(self, *a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["gated"] += 1
        rec["last"] = (self, a, k)
        rec["graphs"].append(self.graphs)
        return result

    setattr(module, attr, make_recording)
    GraphFunction.__call__ = timed

    def undo():
        setattr(module, attr, make)
        GraphFunction.__call__ = call

    rec["undo"] = undo
    return rec


def _num_envs(overrides) -> int:
    return int([o for o in overrides if o.startswith("env.num_envs=")][-1].split("=")[1])


def _anakin_run(torch, name: str, overrides, log_dir: Path, trainer_cls, module, attr: str) -> dict:
    """An Anakin run through ``cli.run``: its iterations, env steps/s, peak
    memory, the rollouts' ms per step, every rollout free of host
    synchronisation; then the last rollout run once more under the
    profiler and the gate: launches per rollout step and the device's busy
    share in the rollout (against the steady unprofiled rollouts' median)."""
    from torch.profiler import ProfilerActivity, profile

    num_envs = _num_envs(overrides)
    rec = _instrument_rollouts(torch, module, attr)
    try:
        run_ = _train_on_policy(torch, overrides, log_dir, trainer_cls)
    finally:
        rec["undo"]()
    T = rec["steps"]
    if rec["gated"] != run_["iterations"] or len(rec["ms"]) != run_["iterations"]:
        raise AssertionError(f"{name}: {len(rec['ms'])} rollouts for {run_['iterations']} iterations, "
                             f"{rec['gated']} under the sync gate")
    rollout_ms = statistics.median(rec["ms"][1:])
    out = {**{k: run_[k] for k in ("iterations", "iteration_s", "update_s", "iterations_per_s", "peak_bytes",
                                   "first_iteration_s", "snapshot", "counts")},
           "env_steps_per_s": run_["iterations_per_s"] * T * num_envs, "rollout_ms": rec["ms"],
           "rollout_step_ms": rollout_ms / T, "gated_rollouts": rec["gated"], "sync_free": True}
    out["rollout_graphs"] = all(rec["graphs"])
    log(f"[{name}] {num_envs} envs x {T} steps: {out['env_steps_per_s']:.1f} env steps/s; rollouts "
        f"{', '.join(f'{ms:.1f}' for ms in rec['ms'])} ms ({out['rollout_step_ms']:.3f} ms per step after the "
        f"first; {'a captured CUDA graph' if out['rollout_graphs'] else 'eager'}); {rec['gated']} rollouts under "
        f"set_sync_debug_mode('error'), no synchronising call; peak device memory {run_['peak_bytes'] / 2**30:.2f} "
        f"GiB")
    rollout, a, k = rec.pop("last")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            rollout(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    del rollout, a, k
    device_ms, launches = _log_profile(name, prof, rollout_ms, f"one rollout of {T} steps",
                                       "(the median steady rollout, unprofiled)")
    out.update(rollout_device_ms=device_ms, launches_per_step=launches / T, rollout_busy=device_ms / rollout_ms)
    log(f"[{name}] {launches / T:.1f} launches per rollout step (the policy forward, the sample, the env step and "
        f"autoreset, the bootstrap forward on final_obs, the bookkeeping)")
    return out


def phase_anakin_ppo(torch, run_root: Path) -> dict:
    """Phase 26: Anakin PPO on jax_cartpole at 1024 envs, beside the adapter path at 16."""
    from sheeprl_tpu_torch.algos.ppo import ppo as ppo_mod

    anakin = _anakin_run(torch, "anakin-ppo", ANAKIN_PPO, run_root / "anakin_ppo", ppo_mod.PPOTrainer, ppo_mod,
                         "make_rollout_fn")
    adapter = _train_on_policy(torch, ADAPTER_PPO, run_root / "adapter_ppo", ppo_mod.PPOTrainer)
    adapter["env_steps_per_s"] = adapter["iterations_per_s"] * 128 * _num_envs(ADAPTER_PPO)  # the recipe's rollout
    ratio = anakin["env_steps_per_s"] / adapter["env_steps_per_s"]
    log(f"[anakin-ppo] Anakin at {_num_envs(ANAKIN_PPO)} envs {anakin['env_steps_per_s']:.1f} env steps/s; the "
        f"adapter path at {_num_envs(ADAPTER_PPO)} envs {adapter['env_steps_per_s']:.1f} env steps/s ({ratio:.1f}x)")
    return {"anakin": anakin, "adapter": {k: adapter[k] for k in ("iterations", "iteration_s", "env_steps_per_s",
                                                                  "peak_bytes", "counts")}}


def phase_anakin_family(torch, run_root: Path) -> dict:
    """Phase 27: Anakin PPO through the CNN on forage, A2C under both
    RMSprops and recurrent PPO, 2 iterations each under the sync gate."""
    from sheeprl_tpu_torch.algos.a2c.a2c import A2CTrainer
    from sheeprl_tpu_torch.algos.ppo import ppo as ppo_mod
    from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent as rec_mod

    runs = {
        "anakin-forage": (ANAKIN_FORAGE, ppo_mod.PPOTrainer, ppo_mod, "make_rollout_fn"),
        "anakin-a2c-rmsprop": (ANAKIN_A2C, A2CTrainer, ppo_mod, "make_rollout_fn"),
        "anakin-a2c-rmsprop_tf": ((*ANAKIN_A2C, *RMSPROP_TF), A2CTrainer, ppo_mod, "make_rollout_fn"),
        "anakin-ppo_recurrent": (ANAKIN_RECURRENT, rec_mod.RecurrentPPOTrainer, rec_mod, "make_recurrent_rollout_fn"),
    }
    out = {}
    for name, (overrides, trainer_cls, module, attr) in runs.items():
        out[name] = _anakin_run(torch, name, overrides, run_root / name, trainer_cls, module, attr)
        if out[name]["iterations"] != 2:
            raise AssertionError(f"{name} ran {out[name]['iterations']} iterations, expected 2")
    return out


def phase_dv3_forage(torch, run_root: Path) -> dict:
    """Phase 28: DreamerV3-XL on forage through the adapter, the fused RSSM
    kernel 80 times per update; one update held to the plain RSSM."""
    train = _train(torch, DV3_FORAGE, run_root / "dv3_forage", "rssm")
    if train["counts"]["gru"]:
        raise AssertionError(f"the forage run launched the gru kernel: {train['counts']}")
    parity = phase_train_parity(torch, train["snapshot"], tag="forage-parity", controls=False)
    return {"train": train, "parity": parity}


def phase_ppo_atari_forage(torch, run_root: Path) -> dict:
    """Phase 29: ``exp=ppo_atari`` at Atari's input (84x84, gray, 4 frames) on forage."""
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer

    run_ = _train_on_policy(torch, PPO_ATARI_FORAGE, run_root / "ppo_atari_forage", PPOTrainer, keep_last=True)
    trainer, (rollout, *_) = run_.pop("trainer"), run_.pop("args")
    first = next(m for m in trainer.agent.modules() if isinstance(m, torch.nn.Conv2d))
    if tuple(rollout["rgb"].shape[2:]) != (84, 84, 4) or first.in_channels != 4:
        raise AssertionError(f"the CNN sees {tuple(rollout['rgb'].shape[2:])}, {first.in_channels} channels; "
                             "expected 4 channels of 84x84")
    run_["env_steps_per_s"] = 1024 * run_["iterations_per_s"]
    log(f"[ppo-atari-forage] the CNN sees {first.in_channels} channels of 84x84: {run_['env_steps_per_s']:.1f} env "
        "steps/s in the second iteration")
    del trainer, rollout
    return run_


def phase_sac_pendulum(torch, run_root: Path) -> dict:
    """Phase 30: SAC on its recipe's pendulum through the adapter."""
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainer

    run_ = _train_off_policy(torch, SAC_PENDULUM, run_root / "sac_pendulum", SACTrainer)
    run_.pop("trainer", None)
    run_.pop("batches", None)
    return run_


def phase_envs(torch, run_root: Path, parity: bool = True) -> dict:
    """Phases 25-30 (without ``parity``, 26-30: the whole run has 25, which
    compares and times nothing, among the checks beside phase 49's child)."""
    t0 = time.perf_counter()
    out = {"parity": phase_env_parity(torch) if parity else None, "ppo": phase_anakin_ppo(torch, run_root),
           "family": phase_anakin_family(torch, run_root), "dv3_forage": phase_dv3_forage(torch, run_root),
           "ppo_atari_forage": phase_ppo_atari_forage(torch, run_root),
           "sac_pendulum": phase_sac_pendulum(torch, run_root)}
    log(f"[envs] phases 25-30 in {time.perf_counter() - t0:.1f} s")
    return out


def envs_summary(envs: dict) -> dict:
    """The numbers of phases 25-30 for a JSON line."""
    keep = ("env_steps_per_s", "rollout_step_ms", "launches_per_step", "rollout_busy", "gated_rollouts",
            "iterations", "iteration_s", "peak_bytes")
    dv3 = envs["dv3_forage"]
    return {
        "parity": envs["parity"],
        "anakin_ppo": {k: envs["ppo"]["anakin"].get(k) for k in keep},
        "adapter_ppo": envs["ppo"]["adapter"],
        **{name: {k: r.get(k) for k in keep} for name, r in envs["family"].items()},
        "dv3_forage": {**{k: dv3["train"][k] for k in ("updates", "updates_per_s", "first_update_s", "peak_bytes",
                                                       "per_update")},
                       "parity": {k: dv3["parity"]["diffs"][k] for k in ("loss_rel", "grad_norm_rel", "latent_abs")}},
        "ppo_atari_forage": {k: envs["ppo_atari_forage"][k] for k in ("env_steps_per_s", "iteration_s", "peak_bytes")},
        "sac_pendulum": {k: envs["sac_pendulum"][k] for k in ("updates", "updates_per_s", "env_steps_per_s",
                                                              "peak_bytes")},
    }


# -- the device-resident replay (phases 31-36) --------------------------------
# Phase 32: phase 7's XL recipe on a 250,000-step ring (the recipe's
# 1,000,000 under the default 8 GiB budget, cut by 4 in both), on the card by
# buffer.device=auto, under a 2 GiB budget: the window shrinks and the host
# spill, memmapped in the run directory, shadows the whole ring.  Replay
# ratio 1/8: 8 updates at step 65, then one every 8 env steps: 12 by step
# 97, the last 4 windows under the guard.
REPLAY_XL_BUDGET = 2 << 30
REPLAY_BUDGET_ENV = "SHEEPRL_REPLAY_BUDGET_BYTES"
REPLAY_DV3_XL = (*(o for o in XL_TRAIN if not o.startswith(("buffer.size", "buffer.memmap"))), FUSED,
                 "buffer.size=250000", "buffer.memmap=True", "buffer.transfer_guard=True",
                 "algo.replay_ratio=0.125", "algo.total_steps=97", "algo.run_test=False")
# Phase 34: phases 20-22's widths on the card's ring, the guard armed; DroQ's
# first window cut from 1,000 updates to 500, then 20 a step: 700
REPLAY_OFF_POLICY = {
    "sac": (*(o for o in SAC_STATE if o != HOST_RING), "buffer.transfer_guard=True"),
    "droq": (*(o for o in DROQ_STATE if o not in (HOST_RING, "algo.learning_starts=20", "algo.total_steps=30")),
             "algo.learning_starts=10", "algo.total_steps=20", "buffer.transfer_guard=True"),
    "sac_ae": (*(o for o in SAC_AE_RGB if o != HOST_RING), "buffer.transfer_guard=True"),
}
# Phase 35: SAC under a byte budget of 256 steps (a step is 48 bytes: the
# observation and the next one, 4 x fp32 each, the 2-wide action, reward and
# terminated), so the spill is armed and the checkpoint comes from it; the
# first run wraps the window (300 steps, 200 updates), the resumed one
# re-waits the 100-step prefill and trains 100 more.  Then a small
# DreamerV3 (the XS preset, 2 envs) whose checkpoint is the ring itself.
REPLAY_SAC_BUDGET = 48 * 256
REPLAY_SAC_RESUME = ("exp=sac", *(o for o in OFF_POLICY if o != "buffer.checkpoint=False"), "buffer.checkpoint=True",
                     "buffer.transfer_guard=True", "algo.learning_starts=100")
REPLAY_DV3_SMALL = ("exp=dreamer_v3", "env=dummy", "env.sync_env=True", "env.id=discrete_dummy", "algo=dreamer_v3_XS", "env.num_envs=2",
                    "fabric.accelerator=gpu", "metric/logger=csv", "checkpoint.save_last=True",
                    "checkpoint.every=1000000000", "checkpoint.async_save=False", "buffer.memmap=False",
                    "buffer.checkpoint=True", "buffer.size=400", "buffer.transfer_guard=True",
                    "algo.per_rank_batch_size=4", "algo.per_rank_sequence_length=16", "algo.learning_starts=40",
                    "algo.replay_ratio=0.25", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
                    "algo.run_test=False", "seed=5")
# (first run's policy steps, the resumed run's, whether the checkpoint comes from the spill)
REPLAY_RESUMES = {"sac": (REPLAY_SAC_RESUME, 300, 500, True), "dv3": (REPLAY_DV3_SMALL, 120, 240, False)}


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _same(a, b) -> bool:
    """Two snapshots (nested dicts and lists of arrays, tensors and scalars) equal bit for bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    x, y = _host(a), _host(b)
    return x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y)


def phase_replay_ring(torch) -> dict:
    """Phase 31: one ring on the card and one on the CPU fed the same adds (3
    envs, a window of 16, 23 steps with a row for env 2 alone every 4th, one
    ``repair_tail``, wrapping): contents and cursors, the uniform batches
    (with ``derive_next``) and sequence blocks gathered at the same draws,
    and both checkpoint round trips (the ring's snapshot and the spill
    tier's) equal bit for bit."""
    from sheeprl_tpu_torch.data.device_replay import DeviceReplay, HostSpill, draw_sequence, draw_uniform

    def filled(device, spill: bool):
        rng = np.random.default_rng(31)
        rb = DeviceReplay(16, 3, device, spill=HostSpill(40, 3, sequential=True) if spill else None)
        for t in range(23):
            rows = {"obs": rng.standard_normal((1, 3, 4)).astype(np.float32),
                    "rgb": rng.integers(0, 256, (1, 3, 64, 64, 3), dtype=np.uint8),
                    **{k: (rng.random((1, 3, 1)) < 0.2).astype(np.float32)
                       for k in ("terminated", "truncated", "is_first")}}
            rb.add(rows)
            if t % 4 == 0:
                rb.add({k: v[:, :1] for k, v in rows.items()}, indices=[2])
            if t == 11:
                rb.repair_tail(1)
        return rb

    def tail_patched(rb):
        ring = {k: v.clone() for k, v in rb.buffers.items()}
        ring["truncated"][torch.as_tensor((rb._pos_h - 1) % rb.capacity), torch.arange(rb.n_envs)] = 1.0
        return ring

    t0 = time.perf_counter()
    cpu, card = filled("cpu", False), filled(CARD, False)
    bad = [k for k in cpu.keys() if not torch.equal(cpu.buffers[k], card.buffers[k].cpu())]
    bad += [f"cursor {c}" for c in ("pos", "filled") if not torch.equal(cpu.cursor[c], card.cursor[c].cpu())]
    gen = torch.Generator().manual_seed(31)
    uniform, sequence = draw_uniform(gen, 64, 3), draw_sequence(gen, 24, 3)
    for derive in (False, True):
        idx = [rb.uniform_indices_from(*(d.to(rb.device) for d in uniform), sample_next_obs=derive) for rb in (cpu, card)]
        got = [rb.sample_uniform(None, 16, 4, derive_next=("obs", "rgb") if derive else (), indices=i)
               for rb, i in zip((cpu, card), idx)]
        bad += [f"uniform{'+next' * derive} {k}" for k in got[0] if not torch.equal(got[0][k], got[1][k].cpu())]
    idx = [rb.sequence_indices_from(*(d.to(rb.device) for d in sequence), 5) for rb in (cpu, card)]
    got = [rb.sample_sequences(None, 8, 5, 3, indices=i) for rb, i in zip((cpu, card), idx)]
    bad += [f"sequence {k}" for k in got[0] if not torch.equal(got[0][k], got[1][k].cpu())]
    state = card.state_dict()
    bad += [] if _same(state, cpu.state_dict()) else ["the ring's snapshot"]
    again = DeviceReplay(16, 3, CARD).load_state_dict(state)
    bad += [] if _same(again.buffers, tail_patched(card)) else ["the ring restored from its snapshot"]
    cpu_s, card_s = filled("cpu", True), filled(CARD, True)
    state = card_s.state_dict()
    bad += [] if state["device_replay"]["from_spill"] and _same(state, cpu_s.state_dict()) else ["the spill's snapshot"]
    again_s = DeviceReplay(16, 3, CARD, spill=HostSpill(40, 3, sequential=True)).load_state_dict(state)
    bad += [] if _same(again_s.buffers, tail_patched(card_s)) else ["the ring restored from the spill"]
    bad += [] if _same(again_s.cursor, card_s.cursor) else ["the cursors restored from the spill"]
    for rb in (cpu_s, card_s, again_s):
        rb.spill.close()
    log(f"[replay-ring] card vs CPU, 3 envs x window 16, 23 steps + subset rows + repair_tail: {len(cpu.keys())} "
        f"ring tensors, both cursors, 2 x 64 uniform draws, 24 sequences of 5, the ring's and the spill's "
        f"snapshots and their restores: {'all equal bit for bit' if not bad else 'DIFFER: ' + ', '.join(bad)} "
        f"({time.perf_counter() - t0:.1f} s)")
    if bad:
        raise AssertionError(f"the card's ring differs from the CPU's: {bad}")
    return {"checked": True}


def phase_replay_dv3(torch, run_root: Path, host: dict) -> dict:
    """Phase 32: DreamerV3-XL on the card's ring through ``cli.run``
    (``REPLAY_DV3_XL``): the window, the ring's bytes on the card, updates/s
    beside phase 7's host ring from the same run, 80 rssm launches in every
    update, every window after the first under ``steady_guard``."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3
    from sheeprl_tpu_torch.data.device_replay import DeviceReplay

    seen, flags = {}, []
    init, add, guard = DeviceReplay.__init__, DeviceReplay.add, dreamer_v3.steady_guard

    def spy_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        seen["rb"] = self

    def spy_add(self, data, indices=None):
        if "ring_bytes" in seen:
            return add(self, data, indices)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        add(self, data, indices)  # the first add allocates every key of the ring
        torch.cuda.synchronize()
        seen["ring_bytes"] = torch.cuda.memory_allocated() - before

    @contextlib.contextmanager
    def spy_guard(enabled):
        flags.append(bool(enabled))
        with guard(enabled):
            yield

    DeviceReplay.__init__, DeviceReplay.add, dreamer_v3.steady_guard = spy_init, spy_add, spy_guard
    budget = os.environ.get(REPLAY_BUDGET_ENV)
    os.environ[REPLAY_BUDGET_ENV] = str(REPLAY_XL_BUDGET)
    try:
        run_ = _train(torch, REPLAY_DV3_XL, run_root / "replay_xl", "rssm", events_only=True, snapshot=False)
        run_.pop("trainer")
    finally:
        DeviceReplay.__init__, DeviceReplay.add, dreamer_v3.steady_guard = init, add, guard
        _restore_env(REPLAY_BUDGET_ENV, budget)
    rb = seen.pop("rb")
    if rb.device.type != torch.device(CARD).type or rb.spill is None or not rb.capacity < 250_000 or rb.spill.degraded:
        raise AssertionError(f"expected a card ring under the budget with a healthy spill: {rb.device}, window "
                             f"{rb.capacity}, spill {rb.spill}")
    if run_["counts"]["gru"] or flags[0] or flags != sorted(flags) or flags.count(True) < 3:
        raise AssertionError(f"launches {run_['counts']}, guarded windows {flags}")
    memmaps = sorted((run_root / "replay_xl").glob("**/memmap_buffer"))
    files = [f for d in memmaps for f in d.rglob("*") if f.is_file()]
    apparent, on_disk = sum(f.stat().st_size for f in files), sum(f.stat().st_blocks * 512 for f in files)
    for d in memmaps:
        shutil.rmtree(d)
    if not memmaps or any(d.exists() for d in memmaps):
        raise AssertionError(f"the spill's memmap under the run directory: {memmaps}")
    out = {"window": rb.capacity, "ring_bytes": seen["ring_bytes"], "hbm_bytes": rb.hbm_bytes,
           "spill_files_bytes": apparent, "spill_disk_bytes": on_disk, "guarded_windows": flags.count(True),
           **{k: run_[k] for k in ("updates", "updates_per_s", "first_update_s", "peak_bytes", "per_update",
                                    "update_launches", "counts", "event_s")}}
    log(f"[replay-xl] DreamerV3-XL on the card's ring: buffer.size 250,000 under a {REPLAY_XL_BUDGET / 2**30:.0f} GiB "
        f"budget -> a window of {rb.capacity:,} steps, "
        f"{seen['ring_bytes'] / 2**30:.3f} GiB on the card (torch.cuda.memory_allocated across the first add; the "
        f"ring's tensors {rb.hbm_bytes / 2**30:.3f} GiB); the spill's memmap {apparent / 2**30:.2f} GiB in files, "
        f"{on_disk / 2**20:.1f} MiB on disk, deleted; {run_['updates']} updates, {flags.count(True)} of "
        f"{len(flags)} chunks under steady_guard; {run_['updates_per_s']:.3f} updates/s (CUDA events), first update "
        f"{run_['first_update_s']:.3f} s, peak {run_['peak_bytes'] / 2**30:.2f} GiB, rssm launches per update "
        f"{sorted(set(run_['per_update']))}; phase 7's host ring in this run: {host['updates_per_s_events']:.3f} "
        f"updates/s (CUDA events), {host['updates_per_s']:.3f} (wall), first update {host['first_update_s']:.3f} s, "
        f"peak {host['peak_bytes'] / 2**30:.2f} GiB")
    return out


def phase_replay_window_parity(torch, snapshot: Path) -> dict:
    """Phase 33: one XL window at the same indices from a card ring and from
    a host ring holding the same adds (2 envs, a window of 144, 200 steps
    and a row for env 1 alone every 7th): the blocks equal bit for bit, and
    one update on each (phase 7's weights, the same noise and categorical
    samples) gives the same ten losses."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import blocks_to_device, draw_noise, prep_blocks
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
    from sheeprl_tpu_torch.data.device_replay import DeviceReplay
    from sheeprl_tpu_torch.utils.distribution import OneHotCategorical

    gc.collect()
    torch.cuda.empty_cache()
    cfg, trainer, dims = _trainer_from_snapshot(torch, snapshot)
    L, B, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size), int(cfg.algo.horizon)
    cap, E = 2 * L + 16, 2
    card = DeviceReplay(cap, E, CARD)
    host = EnvIndependentReplayBuffer(cap, n_envs=E, buffer_cls=SequentialReplayBuffer)
    rng = np.random.default_rng(33)
    for t in range(200):
        rows = {"rgb": rng.integers(0, 256, (1, E, 64, 64, 3), dtype=np.uint8),
                "state": rng.standard_normal((1, E, 4)).astype(np.float32),
                "actions": np.eye(dims[0], dtype=np.float32)[rng.integers(0, dims[0], (1, E))],
                **{k: (rng.random((1, E, 1)) < 0.02).astype(np.float32)
                   for k in ("rewards", "terminated", "truncated", "is_first")}}
        for rb in (card, host):
            rb.add(rows)
            if t % 7 == 0:
                rb.add({k: v[:, 1:] for k, v in rows.items()}, indices=[1])
    t_idx, env = card.sequence_indices(torch.Generator(CARD).manual_seed(33), B, L)
    card_blocks = prep_blocks(card.sample_sequences(None, B, L, 1, indices=(t_idx, env)), trainer.cnn_keys,
                              trainer.mlp_keys)
    t_h, e_h = t_idx.cpu().numpy(), env.cpu().numpy()
    sample = {k: np.stack([host.buffer[e][k][t_h[i], 0] for i, e in enumerate(e_h)], axis=1)[None]
              for k in host.buffer[0].keys()}
    host_blocks = blocks_to_device(sample, trainer.cnn_keys, trainer.mlp_keys, CARD)
    unequal = sorted(set(card_blocks) ^ set(host_blocks)) + [
        k for k in host_blocks if k in card_blocks and not torch.equal(host_blocks[k], card_blocks[k])]
    if unequal:
        raise AssertionError(f"the card ring's blocks differ from the host ring's: {unequal}")

    # the layer this phase holds: one update's (L, B) block made ready on the
    # card, drawn and gathered there, against sampled on the host and copied
    def timed_ms(make, n: int = 20) -> float:
        make()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            make()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    gen = torch.Generator(CARD).manual_seed(1)
    block_ms = {
        "card": timed_ms(lambda: prep_blocks(card.sample_sequences(gen, B, L, 1), trainer.cnn_keys, trainer.mlp_keys)),
        "host": timed_ms(lambda: blocks_to_device(host.sample(B, n_samples=1, sequence_length=L), trainer.cnn_keys,
                                                  trainer.mlp_keys, CARD)),
    }
    block_bytes = sum(v.numel() * v.element_size() for v in card_blocks.values())

    noise = draw_noise(trainer.world_model, trainer.actor, 1, L, B, H, torch.Generator(CARD).manual_seed(33),
                       trainer.task_rollout)
    start = trainer.snapshot()
    samples, replay = [], {"on": False, "i": 0}
    sample_from_noise = OneHotCategorical.sample_from_noise

    def recorded_sample(self, n):
        if replay["on"]:
            replay["i"] += 1
            return samples[replay["i"] - 1]
        samples.append(sample_from_noise(self, n))
        return samples[-1]

    OneHotCategorical.sample_from_noise = recorded_sample
    try:
        card_m = np.array([float(m) for m in trainer.train_phase(card_blocks, noise, 1)])
        trainer.restore(start)
        replay["on"] = True
        host_m = np.array([float(m) for m in trainer.train_phase(host_blocks, noise, 1)])
    finally:
        OneHotCategorical.sample_from_noise = sample_from_noise
    rel = np.abs(card_m - host_m) / np.maximum(np.abs(host_m), 1e-6)
    log(f"[replay-parity] one XL window (batch {B} x sequence {L}) at the same indices: {len(host_blocks)} blocks "
        f"equal bit for bit; one update on each: {int((card_m == host_m).sum())} of 10 losses equal bit for bit, "
        f"max rel diff {rel.max():.3g} (limit {TRAIN_TOL_REL}; {len(samples)} categorical samples replayed); one "
        f"update's block ({block_bytes / 2**20:.2f} MiB) ready on the card in {block_ms['card']:.3f} ms drawn and "
        f"gathered there, {block_ms['host']:.3f} ms sampled on the host and copied (medians of 20, synchronised)")
    if not (rel.max() <= TRAIN_TOL_REL and np.isfinite(card_m).all()):
        raise AssertionError(f"the update on the card ring's blocks differs: {card_m} vs {host_m}")
    del trainer, start
    torch.cuda.empty_cache()
    return {"blocks_equal": True, "losses_equal": int((card_m == host_m).sum()), "loss_rel": float(rel.max()),
            "block_ms": block_ms, "block_bytes": block_bytes}


def phase_replay_off_policy(torch, run_root: Path, host: dict) -> dict:
    """Phase 34: SAC, DroQ and SAC-AE on the card's ring at phases 20-22's
    widths, the guard armed: updates/s beside phases 20-22's host ring,
    launches per update and the busy share of one update drawn from the ring."""
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.algos.sac import sac
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAETrainer

    out = {}
    guard, fused = sac.steady_guard, sac.fused_uniform_train
    for name, trainer_cls in (("sac", sac.SACTrainer), ("droq", sac.SACTrainer), ("sac_ae", SACAETrainer)):
        flags, last = [], {}

        @contextlib.contextmanager
        def spy_guard(enabled, flags=flags):
            flags.append(bool(enabled))
            with guard(enabled):
                yield

        def spy_fused(*args, last=last):
            last["args"] = args
            return fused(*args)

        sac.steady_guard, sac.fused_uniform_train = spy_guard, spy_fused
        try:
            run_ = _train_off_policy(torch, REPLAY_OFF_POLICY[name], run_root / f"{name}_replay", trainer_cls,
                                     events_only=True)
        finally:
            sac.steady_guard, sac.fused_uniform_train = guard, fused
        if flags[0] or flags != sorted(flags) or flags.count(True) < 3:
            raise AssertionError(f"{name}: guarded chunks {flags}")
        trainer, replay, generator, batch_size, _, prep, _ = last["args"]

        def one():
            fused(trainer, replay, generator, batch_size, 1, prep, 0)

        one()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
        total, launches = _log_profile(f"{name}-replay", prof, wall_ms,
                                       f"one {name} update drawn and gathered from the card's ring")
        run_.pop("trainer", None)
        run_.pop("batches", None)
        out[name] = {**{k: run_[k] for k in ("updates", "updates_per_s", "first_update_s", "peak_bytes",
                                             "env_steps_per_s")},
                     "guarded_windows": flags.count(True), "update_device_ms": total, "update_wall_ms": wall_ms,
                     "update_launches": launches, "busy": total / wall_ms}
        h = host[name]
        log(f"[{name}-replay] the card's ring: {run_['updates_per_s']:.1f} updates/s (CUDA events), "
            f"{run_['env_steps_per_s']:.1f} env steps/s, {flags.count(True)} of {len(flags)} chunks guarded, "
            f"{launches} launches per update, busy {total / wall_ms:.1%}; phase "
            f"{ {'sac': 20, 'droq': 21, 'sac_ae': 22}[name]}'s host ring in this run: "
            f"{h['updates_per_s_events']:.1f} updates/s (CUDA events), {h['updates_per_s']:.1f} (wall), "
            f"{h['env_steps_per_s']:.1f} env steps/s")
        del trainer, replay, last
        torch.cuda.empty_cache()
    return out


def phase_replay_resume(torch, run_root: Path) -> dict:
    """Phase 35: a run on the card's ring checkpointed and resumed: SAC
    whose snapshot comes from the spill tier, and a small DreamerV3 whose
    snapshot is the ring with its tail patch; the ring a resume loads equals
    the one saved, and training continues."""
    from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.data.device_replay import DeviceReplay

    saves, loads, out = [], [], {}
    state_dict, load_state_dict = DeviceReplay.state_dict, DeviceReplay.load_state_dict
    budget = os.environ.get("SHEEPRL_REPLAY_BUDGET_BYTES")

    def spy_save(self):
        saves.append(({k: v.clone() for k, v in self.buffers.items()}, self._pos_h.copy()))
        return state_dict(self)

    def spy_load(self, state):
        done = load_state_dict(self, state)
        loads.append({k: v.clone() for k, v in self.buffers.items()})
        return done

    DeviceReplay.state_dict, DeviceReplay.load_state_dict = spy_save, spy_load
    try:
        for name, (overrides, first, second, spilled) in REPLAY_RESUMES.items():
            t0 = time.perf_counter()
            if spilled:
                os.environ["SHEEPRL_REPLAY_BUDGET_BYTES"] = str(REPLAY_SAC_BUDGET)
            saves.clear()
            loads.clear()
            run([*overrides, f"algo.total_steps={first}", f"log_dir={run_root / f'{name}_resume_a'}"])
            snapshot = sorted((run_root / f"{name}_resume_a").glob("**/checkpoint/step_*"))[-1]
            saved = load_step_dir(snapshot)
            ring, pos = saves[-1]
            run([*overrides, f"algo.total_steps={second}", f"checkpoint.resume_from={snapshot}",
                 f"log_dir={run_root / f'{name}_resume_b'}"])
            _restore_env("SHEEPRL_REPLAY_BUDGET_BYTES", budget)
            resumed = load_step_dir(sorted((run_root / f"{name}_resume_b").glob("**/checkpoint/step_*"))[-1])
            if "truncated" in ring:  # no next rows: the write-head rows carry the checkpoint's truncation mark
                cap = ring["truncated"].shape[0]
                ring["truncated"][torch.as_tensor((pos - 1) % cap), torch.arange(len(pos))] = 1.0
            (loaded,) = loads
            equal = _same(ring, loaded)
            from_spill = bool(saved["rb"]["device_replay"]["from_spill"])
            out[name] = {"window": int(next(iter(ring.values())).shape[0]), "from_spill": from_spill,
                         "ring_equal": equal, "grad_steps": (int(saved["grad_steps"]), int(resumed["grad_steps"]))}
            log(f"[{name}-resume] window {out[name]['window']}, snapshot from the "
                f"{'spill tier' if from_spill else 'ring'}: the resumed ring {'equals' if equal else 'DIFFERS FROM'} "
                f"the saved one bit for bit; gradient steps {saved['grad_steps']} -> {resumed['grad_steps']} "
                f"({time.perf_counter() - t0:.1f} s)")
            if not equal or from_spill != spilled or resumed["grad_steps"] <= saved["grad_steps"]:
                raise AssertionError(f"{name}: resume on the card's ring: {out[name]}")
    finally:
        DeviceReplay.state_dict, DeviceReplay.load_state_dict = state_dict, load_state_dict
        _restore_env("SHEEPRL_REPLAY_BUDGET_BYTES", budget)
    return out


def _restore_env(name: str, value) -> None:
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def phase_replay_guard(torch) -> dict:
    """Phase 36: inside ``steady_guard(True)`` on the card a blocking copy
    from the host and a read back raise; explicit staging and work that
    stays on the card do not."""
    from sheeprl_tpu_torch.data.device_replay import stage, stage_scalar, steady_guard

    x = torch.ones(1024, device=CARD)
    probes = {
        "torch.tensor(x, device=cuda)": lambda: torch.tensor([1.0, 2.0], device=CARD),
        "a pageable .to(cuda)": lambda: torch.ones(1024).to(CARD),
        ".item()": lambda: x.sum().item(),
        ".cpu()": lambda: x.cpu(),
        "a truth value": lambda: bool(x.sum() > 0),
    }
    legal = {
        "stage (pinned, non-blocking)": lambda: stage(np.ones(1024, np.float32), CARD),
        "stage_scalar (a fill)": lambda: stage_scalar(0.5, CARD),
        "work on the card": lambda: (x * 2).sum(),
    }
    raised = {}
    for name, fn in {**probes, **legal, "torch.cuda.synchronize()": torch.cuda.synchronize}.items():
        try:
            with steady_guard(True):
                fn()
            raised[name] = False
        except RuntimeError:
            raised[name] = True
    torch.cuda.synchronize()
    log("[replay-guard] inside steady_guard(True): " + "; ".join(
        f"{name} {'raises' if r else 'passes'}" for name, r in raised.items()))
    wrong = [n for n in probes if not raised[n]] + [n for n in legal if raised[n]]
    if wrong:
        raise AssertionError(f"steady_guard on the card: {wrong} behaved otherwise than required")
    return raised


def phase_replay(torch, run_root: Path, host_dv3: dict, host_off: dict) -> dict:
    """Phases 31-36, beside phase 7's and phases 20-22's host-ring runs."""
    t0 = time.perf_counter()
    out = {"ring": phase_replay_ring(torch)}
    out["dv3"] = phase_replay_dv3(torch, run_root, host_dv3)
    out["window_parity"] = phase_replay_window_parity(torch, host_dv3["snapshot"])
    out["off_policy"] = phase_replay_off_policy(torch, run_root, host_off)
    out["resume"] = phase_replay_resume(torch, run_root)
    out["guard"] = phase_replay_guard(torch)
    log(f"[replay] phases 31-36 in {time.perf_counter() - t0:.1f} s")
    return out


def replay_summary(replay: dict) -> dict:
    dv3 = replay["dv3"]
    return {"dv3_xl": {k: dv3[k] for k in ("window", "ring_bytes", "hbm_bytes", "updates", "updates_per_s",
                                            "first_update_s", "peak_bytes", "guarded_windows")},
            "dv3_rssm_per_update": sorted(set(dv3["per_update"])),
            "window_parity": replay["window_parity"], "off_policy": replay["off_policy"],
            "resume": replay["resume"], "guard": replay["guard"]}


# -- the compile-once layer: captured CUDA graphs (phases 37-41) ---------------
GRAPH_CHUNK = 4  # the updates of phases 38-39's window: the loop's GRAPH_WINDOW_UPDATES
GRAPH_TURN_CHUNKS = 1  # chunks per timed turn (eager, graph, graph, eager)


def _profiled(torch, fn) -> tuple:
    """``(device ms, device operations)`` of one call of ``fn``: the kernels,
    copies and fills the card ran, as the CUDA profiler saw them.  Run
    eagerly, each was one call of the host; a replay's host calls are the
    graph function's own count (``replays`` + ``input_copies``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    return sum(ms for _, ms in events), len(events)


def _host_calls(f, fn) -> int:
    """Host calls that put work on the card in one replayed call ``fn()`` of
    the graph function ``f``: its graph launches and input copies."""
    before = f.replays + f.input_copies
    fn()
    return f.replays + f.input_copies - before


def _turns(torch, runs: dict, order=("eager", "graph", "graph", "eager"), calls: int = GRAPH_TURN_CHUNKS) -> dict:
    """Wall seconds of ``calls`` calls of each of ``runs`` in turns, the device
    synchronised around each turn, and the host's seconds until each turn's
    last call returned (before the synchronise)."""
    out = {name: {"s": [], "host_s": []} for name in runs}
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            runs[name]()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out[name]["s"].append(time.perf_counter() - t0)
        out[name]["host_s"].append(host)
    return out


def phase_graph_layer(torch) -> dict:
    """Phase 37: the compile-once layer alone on the card."""
    from sheeprl_tpu_torch.parallel.compile import GraphFunction
    from sheeprl_tpu_torch.telemetry.monitors import CompileMonitor, RecompileLimitExceeded

    dev = torch.device(CARD)
    g = torch.Generator(dev).manual_seed(37)
    w = torch.randn(256, 256, device=dev, generator=g)
    draws = torch.Generator(dev)
    runs = []

    def probe(x, scale):
        y = torch.tanh(x @ w) + scale * torch.rand(x.shape, generator=draws, device=dev)
        return y, y.sum(-1)

    def counted(x, scale):
        runs.append(1)
        return probe(x, scale)

    monitor = CompileMonitor()
    f = GraphFunction(counted, name="graphs.probe", device=dev, generators=(draws,), monitor=monitor)
    x, x2 = torch.randn(64, 256, device=dev, generator=g), torch.randn(64, 256, device=dev, generator=g)
    draws.manual_seed(1)
    want = [probe(x, 0.5) for _ in range(3)] + [probe(x2, 0.5)]
    draws.manual_seed(1)
    got = [tuple(t.clone() for t in f(x, 0.5)) for _ in range(3)] + [tuple(t.clone() for t in f(x2, 0.5))]
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for w_, g_ in zip(want, got) for a, b in zip(w_, g_))
    ran_first = len(runs)  # the first call ran the function twice (eager, then under capture); replays ran it not at all
    f(x[:16], 0.5)
    f(x[:16], 0.5)
    f(x, 0.25)
    builds = monitor.count("graphs.probe")
    if not (equal and ran_first == 2 and builds == f.cache_size() == 3 and len(runs) == 6):
        raise AssertionError(f"graph layer: replay equals eager {equal}, runs {ran_first}/{len(runs)}, builds "
                             f"{builds}, cache {f.cache_size()}")
    capped = GraphFunction(counted, name="graphs.capped", device=dev, generators=(draws,), max_recompiles=0,
                           monitor=CompileMonitor())
    capped(x, 0.5)
    before = len(runs)
    try:
        capped(x[:16], 0.5)
        raise AssertionError("max_recompiles=0 let a second shape through")
    except RecompileLimitExceeded:
        pass
    if len(runs) != before or capped.cache_size() != 1:
        raise AssertionError("the budget tripped after paying for the capture")
    eager_ms = time_ms(torch, lambda: probe(x, 0.5))
    graph_ms = time_ms(torch, lambda: f(x, 0.5))
    bad_monitor = CompileMonitor()
    bad = GraphFunction(lambda x: x * x.sum().item(), name="graphs.item", device=dev, monitor=bad_monitor)
    try:
        bad(x)
        raise AssertionError("a function that calls .item() was captured")
    except RuntimeError as e:
        message = str(e).splitlines()[0]
    if bad.cache_size() or bad_monitor.count("graphs.item"):
        raise AssertionError("a failed capture stayed in the cache or the audit")
    after = GraphFunction(probe, name="graphs.after", device=dev, generators=(draws,), monitor=CompileMonitor())
    draws.manual_seed(3)
    a = probe(x, 0.5)[0]
    draws.manual_seed(3)
    after(x, 0.5)
    draws.manual_seed(3)
    b = after(x, 0.5)[0]
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("a capture after the failed one disagrees with eager")
    log(f"[graphs-layer] replay equals eager bit for bit (4 calls, the generator's draws among them); 3 signatures "
        f"-> 3 captures (the function ran twice at each first call, never on a replay); max_recompiles=0 raised "
        f"before capturing a second shape; .item() under capture raised: {message[:160]}; a capture after it "
        f"equals eager; the probe {eager_ms:.4f} ms eager, {graph_ms:.4f} ms replayed")
    return {"eager_ms": eager_ms, "graph_ms": graph_ms, "captures": builds}


def _fresh_window(torch, overrides, seed: int = 38):
    """A trainer at the recipe's widths (weights from the config's seed) and a
    ring on the card holding 300 random steps of one env."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_dv3_optimizers
    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.data.device_replay import DeviceReplay
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.serve.loader import probe_spaces

    cfg = compose(list(overrides))
    fabric = build_fabric(cfg)
    obs_space, action_space = probe_spaces(cfg)
    dims, cont = spaces_to_dims(action_space)
    modules = build_agent(fabric, dims, cont, cfg, obs_space)
    cnn, mlp = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    trainer = DV3Trainer(cfg, modules, build_dv3_optimizers(cfg, modules, capturable=True), cnn, mlp, cont)
    rng = np.random.default_rng(seed)
    T = 300
    flag = lambda p: (rng.random((T, 1, 1)) < p).astype(np.float32)  # noqa: E731
    rb = DeviceReplay(320, 1, fabric.device)
    rb.add({"rgb": rng.integers(0, 256, (T, 1, 64, 64, 3), dtype=np.uint8),
            "state": rng.standard_normal((T, 1, 4)).astype(np.float32),
            "actions": np.eye(dims[0], dtype=np.float32)[rng.integers(0, dims[0], (T, 1))],
            "rewards": rng.standard_normal((T, 1, 1)).astype(np.float32), "terminated": flag(0.02),
            "truncated": np.zeros((T, 1, 1), np.float32), "is_first": flag(0.02)})
    return cfg, trainer, rb


def phase_graph_window(torch, tag: str, overrides, kernel: str, light: bool = False, keep: bool = False) -> dict:
    """Phases 38-39: one chunk of GRAPH_CHUNK updates of the fused window on
    the card's ring (draw, gather, prep, the trainer's updates), from one
    state and one generator state, eager, then through ``fabric.compile``
    twice (the first call eager then captured: with the first, the two eager
    runs show the device's own non-determinism; the second replayed); then
    the two in turns.
    ``light`` (phases 43-44, whose turns against 32-true and device time by
    kind come from ``phase_precision_turns``): the same equalities, then two
    replayed chunks timed, with no other chunk size, profile or eager turn.
    ``keep``: the built window stays alive under ``out["built"]`` (the
    trainer back at its start, its ring, the window function, its captured
    graph, and without ``light`` the profiles of one update by kind) for
    the phases that run on it; the caller frees it with :func:`_release`.
    Peak memory is counted above what was allocated when the phase began."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import prep_blocks
    from sheeprl_tpu_torch.data.device_replay import fused_sequence_train
    from sheeprl_tpu_torch.ops import gru, rssm
    from sheeprl_tpu_torch.parallel.compile import GraphFunction
    from sheeprl_tpu_torch.telemetry.monitors import CompileMonitor

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counter_of = {"rssm": rssm.LAUNCHES, "gru": gru.LAUNCHES}[kernel]
    cfg, trainer, rb = _fresh_window(torch, overrides)
    L, B = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size)
    dev = trainer.device
    gen = torch.Generator(dev).manual_seed(39)

    def window(n, counter):
        idx = rb.sequence_indices(gen, n * B, L)
        counter, metrics = fused_sequence_train(trainer, rb, gen, B, L, n,
                                                lambda b: prep_blocks(b, trainer.cnn_keys, trainer.mlp_keys),
                                                counter, indices=idx)
        return idx, counter, metrics

    start, g_start = trainer.snapshot(), gen.get_state()
    counter0 = torch.full((), 1, dtype=torch.int64, device=dev)

    def run(fn):
        trainer.restore(start)
        gen.set_state(g_start)
        before = counter_of[kernel]
        idx, counter, metrics = fn(GRAPH_CHUNK, counter0)
        torch.cuda.synchronize()
        return {"idx": idx[0].clone(), "env": idx[1].clone(), "counter": int(counter),
                "metrics": np.array([float(m) for m in metrics]), "launches": counter_of[kernel] - before,
                "params": [t.detach().clone() for t in trainer.tensors()]}

    def compiled(monitor):
        return GraphFunction(window, name=f"{tag}.train_phase_device", static_argnums=(0,), device=dev,
                             generators=(gen,), monitor=monitor)

    # the equalities with cuDNN's deterministic algorithms; two eager runs show
    # what else the device leaves non-deterministic (atomics), which four
    # updates compound
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        f_eq = compiled(CompileMonitor())
        a = run(window)
        t0 = time.perf_counter()
        b = run(f_eq)  # the first call runs the window eagerly (the second eager run), then captures it
        capture_s = time.perf_counter() - t0
        d = run(f_eq)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del f_eq
    same_idx = all(torch.equal(r["idx"], a["idx"]) and torch.equal(r["env"], a["env"]) for r in (b, d))

    def rel(x, y):
        return np.abs(x - y) / np.maximum(np.abs(y), 1e-6)

    rel_d, rel_b = rel(d["metrics"], a["metrics"]), rel(b["metrics"], a["metrics"])
    det_losses = rel_b == 0
    floor = max(float((pb - pa).abs().max()) for pa, pb in zip(a["params"], b["params"]))
    det = [i for i, (pa, pb) in enumerate(zip(a["params"], b["params"])) if torch.equal(pa, pb)]
    det_equal = all(torch.equal(d["params"][i], a["params"][i]) for i in det)
    worst = max(float((pd - pa).abs().max()) for pa, pd in zip(a["params"], d["params"]))
    bit_params = sum(torch.equal(pa, pd) for pa, pd in zip(a["params"], d["params"]))
    param_tol = max(TRAIN_TOL_LATENT, 4 * floor)
    loss_tol = max(TRAIN_TOL_REL, 4 * float(rel_b.max()))
    expected = LAUNCHES_PER_UPDATE * GRAPH_CHUNK
    log(f"[{tag}] one chunk of {GRAPH_CHUNK} updates (batch {B} x sequence {L}), cuDNN deterministic, eager vs "
        f"replayed: indices equal {same_idx}; the ten losses rel diff {', '.join(f'{x:.2e}' for x in rel_d)} "
        f"({int((rel_d == 0).sum())} of 10 bit for bit; eager vs eager {', '.join(f'{x:.2e}' for x in rel_b)}); "
        f"parameters {bit_params} of {len(a['params'])} tensors bit for bit, max abs diff {worst:.3g} (eager vs "
        f"eager: {len(det)} bit for bit, max abs diff {floor:.3g}); counter {d['counter']}; {kernel} launches "
        f"{a['launches']} eager, {d['launches']} credited to the replay; first call (eager + capture) "
        f"{capture_s:.2f} s")
    if not (same_idx and det_equal and all(rel_d[det_losses] == 0) and rel_d.max() <= loss_tol
            and worst <= param_tol and d["counter"] == 1 + GRAPH_CHUNK and a["launches"] == d["launches"] == expected):
        raise AssertionError(f"{tag}: the replayed window disagrees with eager execution (losses within "
                             f"{loss_tol:.3g}, parameters within {param_tol:.3g})")
    del a, b, d
    monitor = CompileMonitor()
    f = compiled(monitor)  # the loop's algorithms from here on

    def eager_chunk():
        window(GRAPH_CHUNK, counter0)

    def graph_chunk():
        f(GRAPH_CHUNK, counter0)

    graph_chunk()  # the capture, before the turns
    built = {"cfg": cfg, "overrides": tuple(overrides), "trainer": trainer, "rb": rb, "window": window, "graph": f,
             "gen": gen, "start": start,
             "g_start": g_start, "counter0": counter0}
    if light:
        turns = _turns(torch, {"graph": graph_chunk}, order=("graph", "graph"))
        ups = {"graph": [GRAPH_CHUNK * GRAPH_TURN_CHUNKS / t for t in turns["graph"]["s"]]}
        captures = monitor.count(f.name)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        log(f"[{tag}] replayed updates/s {', '.join(f'{x:.3f}' for x in ups['graph'])}; {captures} capture; "
            f"{kernel} launches per update {expected // GRAPH_CHUNK} credited per replay; peak device memory "
            f"{peak / 2**30:.2f} GiB")
        if captures != 1:
            raise AssertionError(f"{tag}: {captures} captures for one chunk size")
        out = {"updates_per_s": ups, "host_ms_per_update": None, "device_ms_per_update": None,
               "captures": captures, "peak_bytes": peak, "launches_per_update": expected // GRAPH_CHUNK,
               "loss_rel": float(rel_d.max()), "param_abs": worst, "capture_s": capture_s}
        return _kept(torch, out, built, keep)
    for n in (2, 1):  # every chunk size of a window is one capture
        f(n, counter0)
    # one update each way under the profiler (a chunk of 1: its graph is captured above)
    before = counter_of[kernel]
    eager_kinds = _by_kind(torch, lambda: window(1, counter0))
    built["eager_launches"] = counter_of[kernel] - before
    eager_prof = (sum(v["ms"] for v in eager_kinds.values()), sum(v["ops"] for v in eager_kinds.values()))
    graph_kinds = _by_kind(torch, lambda: f(1, counter0))
    built.update(eager_kinds=eager_kinds, kinds=graph_kinds)
    graph_prof = (sum(v["ms"] for v in graph_kinds.values()), sum(v["ops"] for v in graph_kinds.values()))
    host_graph = _host_calls(f, lambda: f(GRAPH_CHUNK, counter0)) / GRAPH_CHUNK
    # one turn each (graph, eager): the eager turns were cut to one to make
    # room for phases 54-56
    turns = _turns(torch, {"eager": eager_chunk, "graph": graph_chunk}, order=("graph", "eager"))
    per = GRAPH_CHUNK * GRAPH_TURN_CHUNKS
    ups = {k: [per / t for t in v["s"]] for k, v in turns.items()}
    host_ms = {k: [1e3 * t / per for t in v["host_s"]] for k, v in turns.items()}
    captures = monitor.count(f.name)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    out = {"updates_per_s": ups, "host_ms_per_update": host_ms, "captures": captures, "chunk_sizes": [4, 2, 1],
           "host_launches_per_update": {"eager": eager_prof[1], "graph": host_graph},
           "device_kernels_per_update": {"eager": eager_prof[1], "graph": graph_prof[1]},
           "device_ms_per_update": {"eager": eager_prof[0], "graph": graph_prof[0]},
           "launches_per_update": expected // GRAPH_CHUNK, "loss_rel": float(rel_d.max()), "param_abs": worst,
           "peak_bytes": peak, "capture_s": capture_s}
    log(f"[{tag}] updates/s in turns graph {ups['graph'][0]:.3f}, eager {ups['eager'][0]:.3f}; host ms per "
        f"update eager "
        f"{', '.join(f'{x:.1f}' for x in host_ms['eager'])}, graph {', '.join(f'{x:.2f}' for x in host_ms['graph'])}; "
        f"host calls per update eager {out['host_launches_per_update']['eager']:.0f} (every device operation), "
        f"graph {out['host_launches_per_update']['graph']:.2f} (graph launches and input copies); device operations "
        f"per update "
        f"{out['device_kernels_per_update']['eager']:.0f} / {out['device_kernels_per_update']['graph']:.0f}, device "
        f"ms per update {out['device_ms_per_update']['eager']:.1f} / {out['device_ms_per_update']['graph']:.1f}; "
        f"{captures} captures for chunk sizes [4, 2, 1]; {kernel} launches per update {expected // GRAPH_CHUNK} "
        f"credited per replay; peak device memory {peak / 2**30:.2f} GiB")
    if captures != 3:
        raise AssertionError(f"{tag}: {captures} captures for 3 chunk sizes")
    return _kept(torch, out, built, keep)


def _kept(torch, out: dict, built: dict, keep: bool) -> dict:
    """``out`` with the built window under ``"built"`` (its trainer back at
    its start), or with the window freed."""
    built["trainer"].restore(built["start"])
    out["built"] = built
    if not keep:
        _release(torch, out)
    return out


def _release(torch, out: dict) -> None:
    """Free the window :func:`phase_graph_window` kept under ``out["built"]``."""
    out.pop("built", None)
    gc.collect()
    torch.cuda.empty_cache()


# phase 63: one-update windows replayed in turns (3 each), ABBAAB
MATMUL_TURNS = ("highest", "high", "high", "highest", "highest", "high")
MATMUL_KINDS = ("products", "convolutions", "kernel (sheeprl::)")  # the rest: copies, elementwise, reductions
# under "high" the products and the convolutions each take at most this share
# of their fp32 device ms (TF32 in cuBLAS and cuDNN; measured 0.32 and 0.23):
# a setting that did not reach the libraries fails the phase
MATMUL_TF32_SHARE = 0.6


def phase_matmul_precision(torch, fp32: dict) -> dict:
    """Phase 63, on phase 38's kept DreamerV3-XL window ``fp32`` (no other
    XL build): ``matmul_precision`` "highest" (phase 38's window of one
    update, captured with fp32 products, and its profile) against "high"
    (the same window captured with TF32 allowed in cuBLAS and cuDNN through
    ``fabric.apply_matmul_precision``, and profiled): device ms per update by
    kind, where "high" must take at most MATMUL_TF32_SHARE of fp32's
    products and convolutions; the two replayed in turns, 3 each, every turn
    from one state and one generator state, so the first turn of each gives
    the ten losses of the same update; the RSSM kernel on one XL input (the
    posterior's 16 rows) under either setting, bit for bit (its 3xTF32
    products are its own), and against its plain version; 80 rssm launches
    per update credited to each window."""
    from sheeprl_tpu_torch.fabric import apply_matmul_precision
    from sheeprl_tpu_torch.ops import rssm
    from sheeprl_tpu_torch.parallel.compile import GraphFunction
    from sheeprl_tpu_torch.telemetry.monitors import CompileMonitor

    t0 = time.perf_counter()
    trainer, window, gen, counter0 = fp32["trainer"], fp32["window"], fp32["gen"], fp32["counter0"]
    dev = trainer.device
    g = torch.Generator(dev).manual_seed(63)
    D, H = PRESETS["XL"]
    w = _rssm_weights(torch, ZAS[0], D, H, g, dev)
    x = torch.randn(16, ZAS[0], device=dev, generator=g)
    h = torch.tanh(torch.randn(16, H, device=dev, generator=g))
    kernel_out, graphs = {}, {"highest": fp32["graph"]}
    try:
        for name in ("highest", "high"):
            apply_matmul_precision(name, dev)
            kernel_out[name] = rssm.fused_rssm_recurrent(x, h, *w)
        # still "high": the TF32 window is run eagerly and captured under it
        graphs["high"] = GraphFunction(window, name="matmul-high.train_phase_device", static_argnums=(0,),
                                       device=dev, generators=(gen,), monitor=CompileMonitor())
        graphs["high"](1, counter0)
    finally:
        apply_matmul_precision("highest", dev)
    plain_err = float((kernel_out["highest"] - rssm.rssm_recurrent_reference(x, h, *w)).abs().max())
    bitwise = bool(torch.equal(kernel_out["highest"], kernel_out["high"]))
    kinds = {"highest": fp32["kinds"], "high": _by_kind(torch, lambda: graphs["high"](1, counter0))}
    losses, launches, seconds = {}, {}, {name: [] for name in graphs}
    for name in MATMUL_TURNS:
        trainer.restore(fp32["start"])
        gen.set_state(fp32["g_start"])
        before = rssm.LAUNCHES["rssm"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, metrics = graphs[name](1, counter0)
        torch.cuda.synchronize()
        seconds[name].append(time.perf_counter() - t)
        if name not in losses:
            launches[name] = rssm.LAUNCHES["rssm"] - before
            losses[name] = np.array([float(m) for m in metrics])
    ups = {k: [1.0 / t for t in v] for k, v in seconds.items()}
    by_kind = {name: {**{k: kinds[name][k]["ms"] for k in MATMUL_KINDS},
                      "the rest": sum(v["ms"] for k, v in kinds[name].items() if k not in MATMUL_KINDS)}
               for name in graphs}
    tf32_share = {k: by_kind["high"][k] / by_kind["highest"][k] for k in ("products", "convolutions")}
    rel = np.abs(losses["high"] - losses["highest"]) / np.maximum(np.abs(losses["highest"]), 1e-6)
    wm = [0, 1, 2, 3, 4, 5, 8, 9]
    behaviour_ok = np.all(np.abs(losses["high"] - losses["highest"])[6:8]
                          <= PRECISION_TOL_BEHAVIOUR_REL * np.abs(losses["highest"][6:8])
                          + PRECISION_TOL_BEHAVIOUR_ABS)
    for name in graphs:
        log(f"[matmul-precision] {name}: one replayed update's device work "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in by_kind[name].items())
            + f" ({sum(by_kind[name].values()):.1f} ms); rssm launches per update {launches[name]}; updates/s "
            f"{', '.join(f'{u:.3f}' for u in ups[name])}")
    log(f"[matmul-precision] the same update from one state and draws, high against highest: the ten losses rel "
        f"diff {', '.join(f'{v:.2e}' for v in rel)}; the RSSM kernel under both settings bit for bit {bitwise} "
        f"(against its plain version {plain_err:.2e}); high / highest device ms products "
        f"{tf32_share['products']:.3f}, convolutions {tf32_share['convolutions']:.3f}; turns "
        f"{', '.join(MATMUL_TURNS)}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (bitwise and plain_err <= TOL and all(n == LAUNCHES_PER_UPDATE for n in launches.values())
            and all(np.isfinite(v).all() for v in losses.values()) and np.all(rel[wm] <= PRECISION_TOL_WM_REL)
            and behaviour_ok and all(v <= MATMUL_TF32_SHARE for v in tf32_share.values())):
        raise AssertionError(f"[matmul-precision] failed: kernel bit for bit {bitwise}, plain err {plain_err:.3g}, "
                             f"launches {launches}, losses rel {rel}, high / highest device ms {tf32_share} "
                             f"(TF32 at most {MATMUL_TF32_SHARE})")
    del graphs["high"]
    trainer.restore(fp32["start"])
    return {"updates_per_s": ups, "device_ms_per_update": by_kind, "loss_rel": rel.tolist(),
            "losses": {k: v.tolist() for k, v in losses.items()}, "kernel_bitwise": bitwise,
            "kernel_plain_err": plain_err, "launches_per_update": launches, "seconds": time.perf_counter() - t0}


# phases 66-67: the one-device scale layer on phase 38's and 39's kept windows
# (DreamerV3's 1F1B world-model microbatches, the imagination's row chunks,
# algo.remat).  66's two XL windows beside phase 38's monolithic one:
PIPE_WINDOWS = {
    "mb4": ("pipeline.microbatches=4",),  # gradient accumulation over 4 microbatches of 4 rows
    "2stage_remat": ("pipeline=2stage", "pipeline.imagination_microbatches=4", "algo.remat=True"),
}
PIPE_TURNS = ("base", "mb4", "2stage_remat", "2stage_remat", "mb4", "base")
# only the order of float sums separates them from the monolithic update; the
# parameter changes are compared stepping with SGD (CARD_PARITY_SGD) for
# phase 17's reason: the recipe's Adam moves a parameter by about lr x sign(g)
# wherever |g| is near its eps, so a change in the last bits of a gradient
# moves its step by a sizeable share of lr (the Adam changes are reported)
PIPE_TOL_LOSS_REL = 1e-4
PIPE_TOL_CHANGE_L2 = 1e-4
PIPE_SGD = tuple(f"algo.{g}.optimizer.{k}={v}" for g in ("world_model", "actor", "critic")
                 for k, v in CARD_PARITY_SGD.items())
# rssm launches per update: the posterior scan's 64 steps for each of 4
# microbatches (again in the backward under remat) and the imagination's 16
# (discrete actions: imagined without a graph, so nothing re-computed)
PIPE_LAUNCHES = {"mb4": 4 * 64 + 16, "2stage_remat": 2 * 4 * 64 + 16}
# phase 67: DreamerV3-S with the GRU kernel under remat, one chunk of phase 39's window
REMAT_S_LAUNCHES = 2 * 64 + 16


def _sibling_window(torch, built: dict, extra, own_optimizers: bool = False) -> tuple:
    """A DreamerV3 trainer for the kept window's recipe plus ``extra``, on
    the same modules, optimizers and Moments (nothing new on the card), and
    its window over the kept ring and generator; with ``own_optimizers``
    the trainer steps with optimizers of its own, built from ``extra``."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_dv3_optimizers, prep_blocks
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.data.device_replay import fused_sequence_train

    base, rb, gen = built["trainer"], built["rb"], built["gen"]
    cfg = compose([*built["overrides"], *extra])
    optimizers = build_dv3_optimizers(cfg, base.agent) if own_optimizers else base.optimizers
    trainer = DV3Trainer(cfg, base.agent, optimizers, base.cnn_keys, base.mlp_keys, base.is_continuous)
    trainer.moments = base.moments
    L, B = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size)

    def window(n, counter):
        idx = rb.sequence_indices(gen, n * B, L)
        counter, metrics = fused_sequence_train(trainer, rb, gen, B, L, n,
                                                lambda b: prep_blocks(b, trainer.cnn_keys, trainer.mlp_keys),
                                                counter, indices=idx)
        return idx, counter, metrics

    return trainer, window


def _replay_equals_eager(torch, tag: str, built: dict, trainer, window, n: int, counter_of: dict,
                         kernel: str) -> dict:
    """``n`` updates of ``window`` from the kept start state and generator
    state through a graph function, under cuDNN's deterministic algorithms:
    its first call (eager, then captured), then a replay; every trained
    tensor and the ten losses of the replay equal eager's bit for bit, and
    the launches credited to the replay equal eager's."""
    from sheeprl_tpu_torch.parallel.compile import GraphFunction
    from sheeprl_tpu_torch.telemetry.monitors import CompileMonitor

    gen, counter0 = built["gen"], built["counter0"]

    def run(fn):
        trainer.restore(built["start"])
        gen.set_state(built["g_start"])
        before = counter_of[kernel]
        _, counter, metrics = fn(n, counter0)
        torch.cuda.synchronize()
        return {"metrics": np.array([float(m) for m in metrics]), "launches": counter_of[kernel] - before,
                "counter": int(counter), "params": [t.detach().clone() for t in trainer.tensors()]}

    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        f = GraphFunction(window, name=f"{tag}.train_phase_device", static_argnums=(0,), device=trainer.device,
                          generators=(gen,), monitor=CompileMonitor())
        a = run(f)  # the first call runs the window eagerly (then captures it) and returns the eager result
        d = run(f)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del f
    bit = sum(torch.equal(pa, pd) for pa, pd in zip(a["params"], d["params"]))
    bit_losses = int((d["metrics"] == a["metrics"]).sum())
    ok = (bit == len(a["params"]) and bit_losses == len(a["metrics"]) and d["counter"] == a["counter"]
          and a["launches"] == d["launches"])
    out = {"bit_for_bit_params": bit, "params": len(a["params"]), "bit_for_bit_losses": bit_losses,
           "launches_per_update": d["launches"] / n, "ok": ok}
    log(f"[{tag}] {n} update(s) from one state, cuDNN deterministic, replayed vs eager: parameters {bit} of "
        f"{len(a['params'])} tensors bit for bit, losses {bit_losses} of 10 bit for bit; {kernel} launches "
        f"{a['launches']} eager, {d['launches']} credited to the replay; {time.perf_counter() - t0:.1f} s")
    return out


def _peak_of(torch, fn) -> int:
    """Peak device bytes one call of ``fn`` allocates above what was allocated before it."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_pipeline_windows(torch, fp32: dict) -> dict:
    """Phase 66, on phase 38's kept DreamerV3-XL window ``fp32`` (fp32,
    ``fused_pallas``; no other XL build, no second monolithic window): two
    windows of one update on the same modules, optimizers, ring and draws,
    :data:`PIPE_WINDOWS` — (a) 4 world-model microbatches at one stage,
    (b) ``pipeline=2stage`` (2 stages, 4 microbatches) with 4 imagination row
    chunks and ``algo.remat``.  For each: its replay against eager (bit for
    bit, :func:`_replay_equals_eager`), one eager update's peak memory above
    the phase's start, device ms per update by kind, rssm launches per
    update, updates/s in turns with phase 38's captured update
    (:data:`PIPE_TURNS`), and the ten losses and the parameter changes of
    the same update from one state against phase 38's: within
    :data:`PIPE_TOL_LOSS_REL` relative, and the parameter changes of the
    update stepped with SGD (eagerly, :data:`PIPE_SGD`) within
    :data:`PIPE_TOL_CHANGE_L2` relative L2 (the recipe's Adam reported)."""
    from sheeprl_tpu_torch.ops import rssm
    from sheeprl_tpu_torch.parallel.compile import GraphFunction
    from sheeprl_tpu_torch.telemetry.monitors import CompileMonitor

    t0 = time.perf_counter()
    base, gen, counter0 = fp32["trainer"], fp32["gen"], fp32["counter0"]
    windows = {"base": (base, fp32["window"])}
    for key, extra in PIPE_WINDOWS.items():
        windows[key] = _sibling_window(torch, fp32, extra)
    equal = {key: _replay_equals_eager(torch, f"pipeline-{key}", fp32, *windows[key], 1, rssm.LAUNCHES, "rssm")
             for key in PIPE_WINDOWS}
    base.restore(fp32["start"])
    start_params = [t.detach().clone() for t in base.tensors()]

    def one(key):
        def fn():
            base.restore(fp32["start"])
            gen.set_state(fp32["g_start"])
            windows[key][1](1, counter0)
        return fn

    t1 = time.perf_counter()
    peaks = {key: _peak_of(torch, one(key)) for key in windows}
    t2 = time.perf_counter()
    graphs = {"base": fp32["graph"]}
    for key in PIPE_WINDOWS:
        graphs[key] = GraphFunction(windows[key][1], name=f"pipeline-{key}.train_phase_device", static_argnums=(0,),
                                    device=base.device, generators=(gen,), monitor=CompileMonitor())
        graphs[key](1, counter0)  # eager, then captured
    t3 = time.perf_counter()
    kinds = {"base": fp32["kinds"], **{key: _by_kind(torch, lambda k=key: graphs[k](1, counter0))
                                       for key in PIPE_WINDOWS}}
    t4 = time.perf_counter()
    losses, changes, launches, seconds = {}, {}, {}, {key: [] for key in graphs}
    for key in PIPE_TURNS:
        base.restore(fp32["start"])
        gen.set_state(fp32["g_start"])
        before = rssm.LAUNCHES["rssm"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, metrics = graphs[key](1, counter0)
        torch.cuda.synchronize()
        seconds[key].append(time.perf_counter() - t)
        if key not in losses:
            launches[key] = rssm.LAUNCHES["rssm"] - before
            losses[key] = np.array([float(m) for m in metrics])
            changes[key] = torch.cat([(p.detach() - s).flatten() for p, s in zip(base.tensors(), start_params)])
    t5 = time.perf_counter()
    # the same update stepped with SGD, eagerly, for the gate on the parameter changes
    sgd_changes = {}
    for key in windows:
        trainer, window = _sibling_window(torch, fp32, (*PIPE_WINDOWS.get(key, ()), *PIPE_SGD), own_optimizers=True)
        base.restore(fp32["start"])
        gen.set_state(fp32["g_start"])
        window(1, counter0)
        torch.cuda.synchronize()
        sgd_changes[key] = torch.cat([(p.detach() - s_).flatten() for p, s_ in zip(trainer.tensors(), start_params)])
    base.restore(fp32["start"])
    ups = {k: [1.0 / t for t in v] for k, v in seconds.items()}
    out = {"peak_bytes": peaks, "launches_per_update": launches, "updates_per_s": ups, "equal": equal,
           "device_ms_per_update": {k: sum(v["ms"] for v in kinds[k].values()) for k in kinds},
           "kinds": {k: {n: v["ms"] for n, v in kinds[k].items()} for k in kinds}, "loss_rel": {}, "change_l2": {},
           "adam_change_l2": {}, "losses": {k: v.tolist() for k, v in losses.items()}}

    def l2(a, b):
        return float((a - b).norm() / b.norm())

    for key in PIPE_WINDOWS:
        rel = np.abs(losses[key] - losses["base"]) / np.maximum(np.abs(losses["base"]), 1e-6)
        out["loss_rel"][key] = float(rel.max())
        out["change_l2"][key] = l2(sgd_changes[key], sgd_changes["base"])
        out["adam_change_l2"][key] = l2(changes[key], changes["base"])
        log(f"[pipeline-{key}] {', '.join(PIPE_WINDOWS[key])}: peak device memory of one eager update "
            f"{peaks[key] / 2**30:.2f} GiB (monolithic {peaks['base'] / 2**30:.2f}); one replayed update's device "
            f"work {_show_kinds(kinds[key])}; rssm launches per update {launches[key]} (monolithic "
            f"{launches['base']}); updates/s {', '.join(f'{u:.3f}' for u in ups[key])} (monolithic "
            f"{', '.join(f'{u:.3f}' for u in ups['base'])}); the same update from one state: the ten losses rel diff "
            f"{', '.join(f'{v:.2e}' for v in rel)}; the parameter changes stepping with SGD "
            f"{out['change_l2'][key]:.3g} rel L2 (with the recipe's Adam {out['adam_change_l2'][key]:.3g}, reported)")
    out["seconds"] = time.perf_counter() - t0
    log(f"[pipeline] phase 66: turns {', '.join(PIPE_TURNS)}; {out['seconds']:.1f} s (replay against eager "
        f"{t1 - t0:.1f}, peaks {t2 - t1:.1f}, captures {t3 - t2:.1f}, profiles {t4 - t3:.1f}, turns {t5 - t4:.1f}, "
        f"SGD updates {time.perf_counter() - t5:.1f})")
    bad = {k: v for k, v in launches.items() if k != "base" and v != PIPE_LAUNCHES[k]}
    if (bad or not all(e["ok"] for e in equal.values()) or launches["base"] != LAUNCHES_PER_UPDATE
            or any(not np.isfinite(v).all() for v in losses.values())
            or any(v > PIPE_TOL_LOSS_REL for v in out["loss_rel"].values())
            or any(v > PIPE_TOL_CHANGE_L2 for v in out["change_l2"].values())):
        raise AssertionError(f"[pipeline] failed: launches {launches} (expected {PIPE_LAUNCHES}), replay equal "
                             f"{ {k: e['ok'] for k, e in equal.items()} }, losses rel {out['loss_rel']}, changes rel "
                             f"L2 {out['change_l2']}")
    del graphs, windows
    return out


def phase_remat_s(torch, fp32: dict) -> dict:
    """Phase 67, on phase 39's kept DreamerV3-S window (``use_pallas``, the
    GRU kernel): one chunk of GRAPH_CHUNK updates under ``algo.remat``, its
    replay against eager bit for bit; gru launches per update (the
    posterior's 64 steps twice, the imagination's 16)."""
    from sheeprl_tpu_torch.ops import gru

    t0 = time.perf_counter()
    trainer, window = _sibling_window(torch, fp32, ("algo.remat=True",))
    out = _replay_equals_eager(torch, "remat-s", fp32, trainer, window, GRAPH_CHUNK, gru.LAUNCHES, "gru")
    fp32["trainer"].restore(fp32["start"])
    out["seconds"] = time.perf_counter() - t0
    log(f"[remat-s] phase 67: {out['seconds']:.1f} s")
    if not (out["ok"] and out["launches_per_update"] == REMAT_S_LAUNCHES):
        raise AssertionError(f"[remat-s] failed: {out} (expected {REMAT_S_LAUNCHES} gru launches per update)")
    return out


def matmul_precision_only(torch) -> int:
    """``--matmul-precision``: phase 38's XL window and phase 63 on it."""
    def run(run_root):
        xl = phase_graph_window(torch, "graphs-dv3-xl", [*XL_TRAIN, FUSED], "rssm", keep=True)
        try:
            return {"tf32": phase_matmul_precision(torch, xl["built"])}
        finally:
            _release(torch, xl)

    return _mode_only(torch, run)


def scale_only(torch) -> int:
    """``--scale``: phase 38's XL window and phase 66 on it, phase 39's S
    window and phase 67 on it, phases 68-69."""
    def run(run_root):
        out = {}
        for key, recipe, kernel in WINDOW_RECIPES:
            fp32 = phase_graph_window(torch, f"graphs-{key.replace('_', '-')}", recipe, kernel, keep=True)
            try:
                if key == "dv3_xl":
                    out["pipeline"] = phase_pipeline_windows(torch, fp32["built"])
                else:
                    out["remat_s"] = phase_remat_s(torch, fp32["built"])
            finally:
                _release(torch, fp32)
        out.update(phase_decoupled(torch, run_root))
        return out

    return _mode_only(torch, run)


def phase_graph_serve(torch, run_dir: Path, graph_run: dict) -> dict:
    """Phase 40: the served DreamerV3-XL step.  Every ladder rung captured at
    warm-up; at rungs 1 and 32 the replayed step gives the carry and the
    action eager execution gives for the same seed; then an eager service
    (the unwrapped step) over HTTP beside phase 4's captured one."""
    from sheeprl_tpu_torch.serve.service import PolicyService

    service = PolicyService.from_checkpoint(run_dir)
    player = service.player
    t0 = time.perf_counter()
    service.warm_up()
    warm_s = time.perf_counter() - t0
    compiled = player.compiled
    if not (compiled.graphs and compiled.cache_size() == len(service.ladder)):
        raise AssertionError(f"warm-up built {compiled.cache_size()} entries for ladder {service.ladder}")
    wm = player.params["world_model"]
    dev = player.device
    g = torch.Generator(dev).manual_seed(40)
    rng = np.random.default_rng(40)
    worst = 0.0
    for B in (1, 32):
        raw = {"rgb": rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8),
               "state": rng.standard_normal((B, 4)).astype(np.float32)}
        obs = {k: torch.from_numpy(v).to(dev) for k, v in player.prepare(raw).items()}
        h = torch.tanh(torch.randn(B, wm.recurrent_size, device=dev, generator=g))
        z = torch.nn.functional.one_hot(torch.randint(0, wm.discrete_size, (B, wm.stochastic_size), device=dev,
                                                      generator=g), wm.discrete_size).float().reshape(B, -1)
        a = torch.nn.functional.one_hot(torch.randint(0, 4, (B,), device=dev, generator=g), 4).float()
        greedy = torch.arange(B, device=dev) % 2 == 0
        for seed in (3, 4):
            with torch.inference_mode():
                eager = player.step(player.params, (h, z, a), obs, seed, greedy)
                graph = player.dispatch((h, z, a), obs, seed, greedy)
                e = [t.clone() for t in (*eager[0], eager[1])]
                r = [t.clone() for t in (*graph[0], graph[1])]
            torch.cuda.synchronize()
            worst = max(worst, max(float((x - y).abs().max()) for x, y in zip(e, r)))
            if not all(torch.equal(x, y) for x, y in zip(e, r)):
                raise AssertionError(f"rung {B}, seed {seed}: the replayed step differs from eager ({worst:.3g})")
    from sheeprl_tpu_torch.serve.batcher import LatencyTracker
    from sheeprl_tpu_torch.serve.client import PolicyClient
    from sheeprl_tpu_torch.serve.server import PolicyServer

    # the captured and the unwrapped step in turns on one server (dispatch
    # swapped between turns, when no request is in flight)
    ladder, dispatch, valid = list(service.ladder), player.dispatch, _action_check(service)
    server = PolicyServer(service, port=0)
    server.start()
    turns = {"graph": [], "eager": []}
    try:
        for mode in ("graph", "eager", "eager", "graph"):
            player.dispatch = dispatch if mode == "graph" else None
            service.latency = LatencyTracker(8192)
            served0 = PolicyClient(server.url).stats()["served"]
            wall, lat = _client_sessions(server.url, player, valid, SERVE_SESSIONS, SERVE_STEPS)
            st = PolicyClient(server.url).stats()
            if st["served"] - served0 != SERVE_SESSIONS * SERVE_STEPS or st["errors"]:
                raise AssertionError(f"{mode} turn: served {st['served'] - served0}, errors {st['errors']}")
            lat = np.asarray(lat) * 1e3
            turns[mode].append({"actions_per_s": SERVE_SESSIONS * SERVE_STEPS / wall, "p50_ms": st["p50_ms"],
                                "p99_ms": st["p99_ms"], "client_p50_ms": float(np.percentile(lat, 50)),
                                "client_p99_ms": float(np.percentile(lat, 99))})
    finally:
        player.dispatch = dispatch
        server.stop()
    del service, player, compiled, server
    gc.collect()
    torch.cuda.empty_cache()

    def show(rows):
        return "; ".join(f"{r['actions_per_s']:.1f} actions/s, service p50 {r['p50_ms']:.1f} / p99 {r['p99_ms']:.1f} "
                         f"ms" for r in rows)

    log(f"[graphs-serve] ladder {ladder} captured at warm-up in {warm_s:.1f} s; rungs 1 and 32, seeds 3 and 4: "
        f"carry and action of the replayed step equal eager bit for bit; 16 sessions x 8 steps over HTTP in turns "
        f"(graph, eager, eager, graph): captured {show(turns['graph'])}; eager {show(turns['eager'])}; phase 4 "
        f"(captured, a fresh server): {graph_run['actions_per_s']:.1f} actions/s, service p50 "
        f"{graph_run['stats']['p50_ms']:.1f} / p99 {graph_run['stats']['p99_ms']:.1f} ms")
    stats = turns
    return {"warm_s": warm_s, **stats}


def phase_graph_anakin(torch, loop: dict) -> dict:
    """Phase 41: Anakin PPO on jax_cartpole at 1024 envs.  One rollout from one
    state (env state, episode sums, the player's and the env's generators)
    eager and through ``compile_rollout`` twice (first call eager then
    captured, then replayed): trajectories, episode statistics and the new
    state equal bit for bit; then eager and replayed rollouts in turns."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent, sample_actions
    from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs_keys, spaces_to_dims
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.envs.device import vector_env_from_cfg
    from sheeprl_tpu_torch.envs.device.anakin import compile_rollout, init_actor_state, make_rollout_fn
    from sheeprl_tpu_torch.fabric import build_fabric

    cfg = compose(list(ANAKIN_PPO))
    fabric = build_fabric(cfg)
    _, player_gen = fabric.seed_everything(int(cfg.seed), fabric.device)
    venv = vector_env_from_cfg(cfg, fabric.device)
    obs_space, act_space = venv.single_observation_space, venv.single_action_space
    normalize_obs_keys(cfg, obs_space)
    dims, cont = spaces_to_dims(act_space)
    agent = build_agent(fabric, dims, cont, cfg, obs_space, None)
    T, E = int(cfg.algo.rollout_steps), int(cfg.env.num_envs)
    raw = make_rollout_fn(venv, agent, lambda out, noise: sample_actions(out, dims, cont, noise),
                          cnn_keys=tuple(cfg.algo.cnn_keys.encoder), mlp_keys=tuple(cfg.algo.mlp_keys.encoder),
                          action_space=act_space, gamma=float(cfg.algo.gamma), rollout_steps=T)
    compiled = compile_rollout(fabric, raw, player_gen, venv.generator, name="graphs.ppo.rollout")
    actor0 = init_actor_state(venv, 0)
    gens = (player_gen, venv.generator)
    g0 = [gen.get_state() for gen in gens]

    def clone(tree):
        if isinstance(tree, torch.Tensor):
            return tree.clone()
        if hasattr(tree, "_fields"):
            return type(tree)(*(clone(v) for v in tree))
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(clone(v) for v in tree)
        return tree

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, (tuple, list)):
            return [x for v in tree for x in leaves(v)]
        return []

    def once(fn):
        for gen, st in zip(gens, g0):
            gen.set_state(st)
        out = clone(fn(clone(actor0), player_gen))
        torch.cuda.synchronize()
        return out

    eager, first, replay = once(raw), once(compiled), once(compiled)
    pairs = list(zip(leaves(eager), leaves(replay)))
    equal = all(torch.equal(x, y) for x, y in pairs) and all(
        torch.equal(x, y) for x, y in zip(leaves(eager), leaves(first)))
    graphs = compiled.compiled.graphs and compiled.compiled.cache_size() == 1
    if not (equal and graphs):
        raise AssertionError(f"the replayed Anakin rollout: equal to eager {equal}, one captured graph {graphs}")
    state = {"eager": clone(actor0), "graph": clone(actor0)}

    def step(kind, fn):
        def go():
            state[kind] = fn(state[kind], player_gen)[0]
        return go

    eager_prof = _profiled(torch, step("eager", raw))
    graph_prof = _profiled(torch, step("graph", compiled))
    host_graph = _host_calls(compiled.compiled, step("graph", compiled))
    turns = _turns(torch, {"eager": step("eager", raw), "graph": step("graph", compiled)}, calls=3)
    sps = {k: [3 * T * E / t for t in v["s"]] for k, v in turns.items()}
    graph_rollout_ms = 1e3 * statistics.median(turns["graph"]["s"]) / 3
    eager_rollout_ms = 1e3 * statistics.median(turns["eager"]["s"]) / 3
    out = {"env_steps_per_s": sps, "host_launches_per_step": {"eager": eager_prof[1] / T, "graph": host_graph / T},
           "device_kernels_per_step": {"eager": eager_prof[1] / T, "graph": graph_prof[1] / T},
           "busy": {"eager": eager_prof[0] / eager_rollout_ms, "graph": graph_prof[0] / graph_rollout_ms},
           "rollout_ms": {"eager": eager_rollout_ms, "graph": graph_rollout_ms}}
    log(f"[graphs-anakin] {E} envs x {T} steps: trajectories, episode statistics and the new state of the replayed "
        f"rollout equal eager bit for bit ({len(pairs)} tensors); env steps/s of the rollout in turns eager "
        f"{sps['eager'][0]:.0f}, graph {sps['graph'][0]:.0f}, graph {sps['graph'][1]:.0f}, eager {sps['eager'][1]:.0f}; "
        f"host calls per rollout step eager {out['host_launches_per_step']['eager']:.1f} (every device operation), "
        f"graph {out['host_launches_per_step']['graph']:.3f} (graph launches and input copies); device operations "
        f"per step "
        f"{out['device_kernels_per_step']['eager']:.1f} / {out['device_kernels_per_step']['graph']:.1f}; the card busy "
        f"{out['busy']['eager']:.1%} of an eager rollout, {out['busy']['graph']:.1%} of a replayed one"
        + (f"; phase 26 (the loop, rollout captured): {loop['env_steps_per_s']:.0f} env steps/s, "
           f"{loop['rollout_step_ms']:.3f} ms per rollout step" if loop else ""))
    return out


WINDOW_RECIPES = (("dv3_xl", (*XL_TRAIN, FUSED), "rssm"), ("dv3_s_gru", S_TRAIN, "gru"))


def phase_graphs(torch, run_root: Path, served: dict, fused_dir: Path, anakin: dict = None,
                 sac_run: dict = None) -> dict:
    """Phases 37-41, and on phase 38's XL window while it is kept phase 63
    and, given ``sac_run``, phase 51's span turns; on phase 38's and 39's
    windows phases 43-44 (``out["bf16"]``), so that no XL or S window is
    built or captured twice."""
    t0 = time.perf_counter()
    out = {"layer": phase_graph_layer(torch), "bf16": {}}
    for key, recipe, kernel in WINDOW_RECIPES:
        fp32 = phase_graph_window(torch, f"graphs-{key.replace('_', '-')}", recipe, kernel, keep=True)
        try:
            if key == "dv3_xl":
                out["tf32"] = phase_matmul_precision(torch, fp32["built"])
                out["pipeline"] = phase_pipeline_windows(torch, fp32["built"])
                if sac_run is not None:
                    out["spans"] = phase_telemetry_spans(torch, sac_run, fp32["built"])
            else:
                out["remat_s"] = phase_remat_s(torch, fp32["built"])
            out["bf16"][key] = phase_precision_window(torch, key, recipe, kernel, fp32["built"])
        finally:
            _release(torch, fp32)
        out[key] = fp32
    out["serve"] = phase_graph_serve(torch, fused_dir, served)
    out["anakin"] = phase_graph_anakin(torch, anakin)
    out["seconds"] = time.perf_counter() - t0
    log(f"[graphs] phases 37-41: {out['seconds']:.1f} s")
    return out


def graphs_only(torch) -> int:
    """``--graphs``: phases 37-41 alone (after phase 4's served snapshot and
    captured service run, which phase 40 reads beside its eager one)."""
    run_root = ROOT / "build" / "chip_smoke_graphs"
    shutil.rmtree(run_root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        device = phase_device(torch)
        phase_build()
        fused_dir = run_root / "fused_pallas"
        _build_snapshot(torch, [*XL_SERVE, FUSED], fused_dir)
        served = _drive(torch, fused_dir, SERVE_SESSIONS, SERVE_STEPS)
        del served["service"]
        graphs = phase_graphs(torch, run_root, served, fused_dir)
        log("[graphs] " + json.dumps(graphs_summary(graphs), default=float))
        log(f"[graphs] total {time.perf_counter() - t0:.1f} s")
    except BaseException:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


def graphs_summary(graphs: dict) -> dict:
    keep = ("updates_per_s", "host_ms_per_update", "host_launches_per_update", "device_kernels_per_update",
            "captures", "peak_bytes", "launches_per_update", "loss_rel", "param_abs")
    return {"layer": graphs["layer"], **{k: {x: graphs[k][x] for x in keep} for k in ("dv3_xl", "dv3_s_gru")},
            "tf32": {k: graphs["tf32"][k] for k in (
                "updates_per_s", "device_ms_per_update", "loss_rel", "kernel_bitwise", "launches_per_update")},
            "pipeline": {k: graphs["pipeline"][k] for k in (
                "peak_bytes", "launches_per_update", "updates_per_s", "device_ms_per_update", "loss_rel", "change_l2",
                "seconds")},
            "remat_s": graphs["remat_s"],
            "serve": graphs["serve"], "anakin": graphs["anakin"], "seconds": graphs["seconds"]}


# -- the precision policy (phases 42-47) -------------------------------------
BF16_MIXED = "fabric.precision=bf16-mixed"
# The first update of a bf16-mixed window against a 32-true window from the
# same weights, data and draws.  The world-model losses and entropies move by
# bf16 rounding (tests/test_torch_precision.py measures JAX's own bf16 against
# its fp32 at 5.4e-04 to 1.7e-02 relative); the policy and value losses also
# move with every latent or action sample a rounding flips, which JAX's own
# bf16 does too (up to 16% and 7% from a half-ulp change of the weights).
PRECISION_TOL_WM_REL = 5e-2
PRECISION_TOL_BEHAVIOUR_REL, PRECISION_TOL_BEHAVIOUR_ABS = 0.35, 5e-2
PRECISION_BATCHES = (1, 32, 1024)
# device work of one update by kind (first match wins); copies and dtype casts
# share PyTorch's copy kernel, so the casts are the copies bf16 adds to fp32's
KINDS = (
    ("kernel (sheeprl::)", ("sheeprl::",)),
    ("convolutions", ("cudnn", "conv", "implicit_gemm", "wgrad", "dgrad", "fprop")),
    ("products", ("gemm", "gemv", "Kernel2", "nvjet", "xmma")),
    ("copies and casts", ("copy_kernel", "Memcpy", "Memset")),
)
OTHER_KIND = "elementwise and reductions"


def _by_kind(torch, fn) -> dict:
    """Device ms and operations of one call of ``fn`` by kind (:data:`KINDS`)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = {k: [0.0, 0] for k, _ in KINDS}
    kinds[OTHER_KIND] = [0.0, 0]
    for name, ms in _device_events(prof):
        kind = next((k for k, keys in KINDS if any(m in name for m in keys)), OTHER_KIND)
        kinds[kind][0] += ms
        kinds[kind][1] += 1
    return {k: {"ms": ms, "ops": n} for k, (ms, n) in kinds.items()}


def _show_kinds(kinds: dict) -> str:
    total = sum(v["ms"] for v in kinds.values())
    return f"{total:.1f} ms: " + ", ".join(f"{k} {v['ms']:.1f} ms ({v['ms'] / max(total, 1e-9):.0%}, {v['ops']} ops)"
                                          for k, v in kinds.items())


def phase_precision_kernels(torch) -> dict:
    """Phase 42: each kernel at XL on bf16 ``x`` and ``h`` (cast to fp32 by its
    wrapper): bit for bit its call on the fp32 upcasts, within TOL of its plain
    version; the wrapper timed beside the kernel on fp32 operands and the two
    casts alone."""
    from sheeprl_tpu_torch.ops import gru, rssm

    D, H = PRESETS["XL"]
    za = ZAS[0]
    dev = torch.device(CARD)
    g = torch.Generator(dev).manual_seed(42)
    w = _rssm_weights(torch, za, D, H, g, dev)
    bf16 = torch.bfloat16
    out = {"rssm": {}, "gru": {}}
    worst = {"rssm": 0.0, "gru": 0.0}
    for B in PRECISION_BATCHES:
        x = torch.randn(B, za, device=dev, generator=g).to(bf16)
        y = torch.randn(B, D, device=dev, generator=g).to(bf16)
        h = torch.tanh(torch.randn(B, H, device=dev, generator=g)).to(bf16)
        rows = {
            "rssm": (lambda a, b: rssm.fused_rssm_recurrent(a, b, *w),
                     lambda a, b: rssm.rssm_recurrent_reference(a, b, *w), x),
            "gru": (lambda a, b: gru.fused_layernorm_gru(a, b, *w[4:]),
                    lambda a, b: gru.layernorm_gru_reference(a, b, *w[4:]), y),
        }
        for name, (kernel, plain, inp) in rows.items():
            inp32, h32 = inp.float(), h.float()
            got, up, ref = kernel(inp, h), kernel(inp32, h32), plain(inp32, h32)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            worst[name] = max(worst[name], err)
            if not (got.dtype == torch.float32 and torch.equal(got, up) and err <= TOL):
                raise AssertionError(f"{name} B={B} on bf16 operands: dtype {got.dtype}, equal to the fp32 upcasts "
                                     f"{torch.equal(got, up)}, max abs err {err:.3g} (limit {TOL})")
            row = {"wrapper_ms": time_ms(torch, lambda: kernel(inp, h)),
                   "kernel_ms": time_ms(torch, lambda: kernel(inp32, h32)),
                   "cast_ms": time_ms(torch, lambda: (inp.float(), h.float())), "max_abs_err": err}
            out[name][B] = row
            log(f"[precision-kernels] {name} XL B={B}, bf16 x and h: equal to the fp32 upcasts bit for bit, max abs "
                f"err {err:.2e} against the plain version; the wrapper {row['wrapper_ms']:.4f} ms = the kernel on "
                f"fp32 operands {row['kernel_ms']:.4f} ms + the two casts {row['cast_ms']:.4f} ms (2 launches)")
    out["worst"] = worst
    return out


def _first_update(torch, trainer, rb, seed: int):
    """The ten losses of one eager update of ``trainer`` on ``rb`` from a
    generator seeded ``seed``, restoring the trainer's state after it."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import prep_blocks
    from sheeprl_tpu_torch.data.device_replay import fused_sequence_train

    L, B = int(trainer.cfg.algo.per_rank_sequence_length), int(trainer.cfg.algo.per_rank_batch_size)
    start = trainer.snapshot()
    gen = torch.Generator(trainer.device).manual_seed(seed)
    counter0 = torch.full((), 1, dtype=torch.int64, device=trainer.device)
    _, metrics = fused_sequence_train(trainer, rb, gen, B, L, 1,
                                      lambda b: prep_blocks(b, trainer.cnn_keys, trainer.mlp_keys), counter0)
    losses = np.array([float(m) for m in metrics])
    trainer.restore(start)
    return losses


def phase_precision_turns(torch, tag: str, kernel: str, runs: dict) -> dict:
    """Phases 43-44 on two kept windows of :func:`phase_graph_window`:
    ``runs["bf16"]``, the light bf16-mixed window, and ``runs["fp32"]``,
    phase 38's (39's) 32-true one, from the same weights and ring data; the
    first update's ten losses of each from the same draws within the stated
    tier; one eager update of each profiled by kind (fp32's is phase 38's
    profile); then their captured chunks of GRAPH_CHUNK updates replayed in
    turns (bf16, fp32, fp32, bf16) and nothing else (the eager chunks are
    not timed)."""
    from sheeprl_tpu_torch.ops import gru, rssm

    counter_of = {"rssm": rssm.LAUNCHES, "gru": gru.LAUNCHES}[kernel]
    for r in runs.values():
        r["trainer"].restore(r["start"])
    same = all(torch.equal(a, b) for a, b in zip(runs["bf16"]["trainer"].tensors(), runs["fp32"]["trainer"].tensors()))
    if not same:
        raise AssertionError(f"{tag}: the bf16 and fp32 trainers do not start from the same weights")
    losses = {k: _first_update(torch, r["trainer"], r["rb"], 43) for k, r in runs.items()}
    rel = np.abs(losses["bf16"] - losses["fp32"]) / np.maximum(np.abs(losses["fp32"]), 1e-6)
    wm = [0, 1, 2, 3, 4, 5, 8, 9]
    behaviour_ok = np.all(np.abs(losses["bf16"] - losses["fp32"])[6:8]
                          <= PRECISION_TOL_BEHAVIOUR_REL * np.abs(losses["fp32"][6:8]) + PRECISION_TOL_BEHAVIOUR_ABS)
    log(f"[{tag}] the first update from the same weights and draws, bf16-mixed against 32-true: the ten losses rel "
        f"diff {', '.join(f'{x:.2e}' for x in rel)}; bf16 {', '.join(f'{x:.6g}' for x in losses['bf16'])}")
    if not (np.isfinite(losses["bf16"]).all() and np.all(rel[wm] <= PRECISION_TOL_WM_REL) and behaviour_ok):
        raise AssertionError(f"{tag}: the bf16 update is off its fp32 twin beyond the tier (world model "
                             f"{PRECISION_TOL_WM_REL}, behaviour {PRECISION_TOL_BEHAVIOUR_REL} rel + "
                             f"{PRECISION_TOL_BEHAVIOUR_ABS})")
    kinds, launches = {}, {}
    for name, r in runs.items():
        if "eager_kinds" in r:
            kinds[name], launches[name] = r["eager_kinds"], r["eager_launches"]
        else:
            before = counter_of[kernel]
            kinds[name] = _by_kind(torch, lambda r=r: r["window"](1, r["counter0"]))
            launches[name] = counter_of[kernel] - before
    if launches["bf16"] != LAUNCHES_PER_UPDATE:
        raise AssertionError(f"{tag}: one bf16 update launched {launches['bf16']} {kernel} kernels, expected "
                             f"{LAUNCHES_PER_UPDATE}")
    graphs = {name: (lambda r=r: r["graph"](GRAPH_CHUNK, r["counter0"])) for name, r in runs.items()}
    order = ("bf16", "fp32", "fp32", "bf16")
    graph_turns = _turns(torch, graphs, order=order)
    # eager chunks are not timed here: they are host-bound, and phases 38-39 time eager turns
    ups = {"graph": {k: [GRAPH_CHUNK / t for t in v["s"]] for k, v in graph_turns.items()}}
    busy = {k: sum(v["ms"] for v in kinds[k].values()) / (1e3 / statistics.median(ups["graph"][k])) for k in runs}
    for name in runs:
        log(f"[{tag}] {name}: one eager update's device work {_show_kinds(kinds[name])}; {kernel} launches per "
            f"update {launches[name]}; busy {busy[name]:.1%} of a replayed update")
    log(f"[{tag}] updates/s in turns (bf16, fp32, fp32, bf16): captured {ups['graph']['bf16'][0]:.3f}, "
        f"{ups['graph']['fp32'][0]:.3f}, {ups['graph']['fp32'][1]:.3f}, {ups['graph']['bf16'][1]:.3f}")
    return {"loss_rel": rel.tolist(), "losses": {k: v.tolist() for k, v in losses.items()}, "kinds": kinds,
            "launches_per_update": launches, "updates_per_s": ups, "busy": busy}


def phase_precision_window(torch, key: str, recipe, kernel: str, fp32: dict) -> dict:
    """Phases 43-44: the bf16-mixed light window of ``recipe`` and its turns
    beside phase 38's (39's) kept 32-true window ``fp32``."""
    tag = f"precision-{key.replace('_', '-')}"
    out = phase_graph_window(torch, tag, [*recipe, BF16_MIXED], kernel, light=True, keep=True)
    try:
        out["turns"] = phase_precision_turns(torch, tag, kernel, {"bf16": out["built"], "fp32": fp32})
    finally:
        _release(torch, out)
    return out


def phase_precision_serve(torch, snapshot: Path) -> dict:
    """Phase 46: the snapshot of a bf16-mixed training run served under its
    own precision: its weights fp32 and loaded unchanged; every rung
    captured at warm-up, rungs 1 and 32 replayed equal eager bit for bit;
    then 16 sessions x 4 steps over HTTP in turns with a 32-true server of the
    same snapshot (bf16, fp32, fp32, bf16), the launch counts zeroed before
    and read after the bf16 turns."""
    from sheeprl_tpu_torch.ops import gru, rssm
    from sheeprl_tpu_torch.serve.batcher import LatencyTracker
    from sheeprl_tpu_torch.serve.client import PolicyClient
    from sheeprl_tpu_torch.serve.server import PolicyServer
    from sheeprl_tpu_torch.serve.service import PolicyService

    services = {"bf16": PolicyService.from_checkpoint(snapshot),
                "fp32": PolicyService.from_checkpoint(snapshot, ["fabric.precision=32-true"])}
    if services["bf16"].fabric.precision.name != "bf16-mixed":
        raise AssertionError(f"the snapshot's run config served {services['bf16'].fabric.precision}")
    state = services["bf16"].fabric.load(snapshot)["agent"]
    player = services["bf16"].player
    wm, actor = player.params["world_model"], player.params["actor"]
    saved = {**{f"world_model.{k}": v for k, v in state["world_model"].items()},
             **{f"actor.{k}": v for k, v in state["actor"].items()}}
    loaded = {**{f"world_model.{k}": v for k, v in wm.state_dict().items()},
              **{f"actor.{k}": v for k, v in actor.state_dict().items()}}
    if not (all(v.dtype == torch.float32 for v in saved.values())
            and all(torch.equal(saved[k], loaded[k]) for k in saved)):
        raise AssertionError("the bf16-trained snapshot is not fp32, or the loader changed its weights")
    if wm.recurrent_model.compute_dtype != torch.bfloat16:
        raise AssertionError("the served world model does not compute in bf16")
    for service in services.values():
        service.warm_up()
    dev = player.device
    g = torch.Generator(dev).manual_seed(46)
    rng = np.random.default_rng(46)
    for B in (1, 32):
        raw = {"rgb": rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8),
               "state": rng.standard_normal((B, 4)).astype(np.float32)}
        obs = {k: torch.from_numpy(v).to(dev) for k, v in player.prepare(raw).items()}
        h = torch.tanh(torch.randn(B, wm.recurrent_size, device=dev, generator=g))
        z = torch.nn.functional.one_hot(torch.randint(0, wm.discrete_size, (B, wm.stochastic_size), device=dev,
                                                      generator=g), wm.discrete_size).float().reshape(B, -1)
        a = torch.nn.functional.one_hot(torch.randint(0, 4, (B,), device=dev, generator=g), 4).float()
        greedy = torch.arange(B, device=dev) % 2 == 0
        with torch.inference_mode():
            eager = player.step(player.params, (h, z, a), obs, 5, greedy)
            e = [t.clone() for t in (*eager[0], eager[1])]
            graph = player.dispatch((h, z, a), obs, 5, greedy)
            r = [t.clone() for t in (*graph[0], graph[1])]
        torch.cuda.synchronize()
        if not (all(torch.equal(x, y) for x, y in zip(e, r)) and e[0].dtype == torch.float32):
            raise AssertionError(f"rung {B}: the replayed bf16 step differs from eager")
    servers = {k: PolicyServer(s, port=0) for k, s in services.items()}
    for server in servers.values():
        server.start()
    turns = {"bf16": [], "fp32": []}
    try:
        for mode in ("bf16", "fp32", "fp32", "bf16"):
            service, server = services[mode], servers[mode]
            service.latency = LatencyTracker(8192)
            served0 = PolicyClient(server.url).stats()["served"]
            rssm.LAUNCHES["rssm"] = gru.LAUNCHES["gru"] = 0
            wall, lat = _client_sessions(server.url, service.player, _action_check(service), SERVE_SESSIONS,
                                         PRECISION_SERVE_STEPS)
            counts = {"rssm": rssm.LAUNCHES["rssm"], "gru": gru.LAUNCHES["gru"]}
            st = PolicyClient(server.url).stats()
            if st["served"] - served0 != SERVE_SESSIONS * PRECISION_SERVE_STEPS or st["errors"] or not counts["rssm"]:
                raise AssertionError(f"{mode} turn: served {st['served'] - served0}, errors {st['errors']}, "
                                     f"launches {counts}")
            lat = np.asarray(lat) * 1e3
            turns[mode].append({"actions_per_s": SERVE_SESSIONS * PRECISION_SERVE_STEPS / wall, "p50_ms": st["p50_ms"],
                                "p99_ms": st["p99_ms"], "client_p50_ms": float(np.percentile(lat, 50)),
                                "client_p99_ms": float(np.percentile(lat, 99)), "counts": counts})
    finally:
        for server in servers.values():
            server.stop()
    del services, servers, player, wm, actor
    gc.collect()
    torch.cuda.empty_cache()

    def show(rows):
        return "; ".join(f"{r['actions_per_s']:.1f} actions/s, service p50 {r['p50_ms']:.1f} / p99 {r['p99_ms']:.1f} "
                         f"ms" for r in rows)

    log(f"[precision-serve] the bf16-mixed snapshot: fp32 weights loaded unchanged; rungs 1 and 32 replayed equal "
        f"eager bit for bit; 16 sessions x 8 steps over HTTP in turns (bf16, fp32, fp32, bf16): bf16 "
        f"{show(turns['bf16'])}; fp32 {show(turns['fp32'])}; rssm launches in the bf16 turns "
        f"{[r['counts']['rssm'] for r in turns['bf16']]}")
    return turns


# Phase 47: every other family under bf16-mixed, one train phase on the card
# against the same phase on the CPU under bf16-mixed (same weights, inputs and
# draws, SGD for every group).  Rows are cut (rollout 64 steps, off-policy
# U 2 x batch 64, the Dreamers' batch 4 x sequence 16; recurrent PPO 16 steps); the models keep their
# recipes' widths.  The gates are the CPU tests' bf16 tiers against JAX
# (tests/test_torch_precision.py): the losses within 3e-2 relative (+1e-3)
# and each module's parameter changes within 0.1 relative L2 where no sample
# is redrawn inside the phase; the Dreamers', whose latent and action samples
# a rounding can flip, within UPDATE_TIERS.
PRECISION_FAMILY_TIER = {"loss_rel": 3e-2, "loss_abs": 1e-3, "change_l2": 0.1}
PRECISION_DREAMER_TIER = {"wm_metric_rel": 5e-2, "behaviour_metric_rel": 0.35, "behaviour_metric_abs": 5e-2,
                          "world_model_l2": 0.25, "behaviour_l2": 0.6}
PRECISION_FAMILIES = {
    # name: (overrides, kind)
    "ppo": ((*PPO_ATARI, "algo.rollout_steps=64", "algo.per_rank_batch_size=32"), "on_policy"),
    "a2c": ((*A2C_ATARI,), "on_policy"),
    "ppo_recurrent": ((*PPO_RECURRENT, "algo.rollout_steps=16"), "recurrent"),
    "sac": ((*SAC_STATE,), "off_policy"),
    "droq": ((*DROQ_STATE,), "off_policy"),
    "sac_ae": ((*SAC_AE_RGB,), "off_policy"),
    "dreamer_v2": (("exp=dreamer_v2", *FAMILY, "algo.per_rank_batch_size=4", "algo.per_rank_sequence_length=16"),
                   "dreamer"),
    "dreamer_v1": (("exp=dreamer_v1", *FAMILY, "algo.per_rank_batch_size=4", "algo.per_rank_sequence_length=16"),
                   "dreamer"),
}


def _family_case(torch, name: str, overrides, kind: str):
    """``make(device, precision) -> (state_of, run)`` for one family: a
    trainer from the family's seed weights on ``device`` under
    ``precision`` with SGD for every group, ``run()`` one train phase on the
    case's fixed inputs and draws (the losses), ``state_of()`` the trained
    tensors on the CPU."""
    import copy

    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.fabric import Fabric, Precision
    from sheeprl_tpu_torch.serve.loader import probe_spaces
    from sheeprl_tpu_torch.utils.optim import build_optimizer

    cfg = compose([*overrides, "fabric.accelerator=cpu"])
    obs_space, act_space = probe_spaces(cfg)
    dims, cont = spaces_to_dims(act_space)
    cnn, mlp = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    rng = np.random.default_rng(47)

    def fabric(device, precision):
        return Fabric(torch.device(device), Precision.from_string(precision))

    def sgd(run_cfg, groups):
        for g in groups:
            run_cfg.algo[g].optimizer = dict(CARD_PARITY_SGD)
        return run_cfg

    if kind in ("on_policy", "recurrent"):
        from sheeprl_tpu_torch.algos.a2c.a2c import A2CTrainer
        from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer, epoch_permutation, rollout_to_device
        from sheeprl_tpu_torch.algos.ppo.utils import prepare_obs
        from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import RecurrentPPOTrainer

        if kind == "on_policy":
            from sheeprl_tpu_torch.algos.ppo.agent import build_agent
        else:
            from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
        T, B = int(cfg.algo.rollout_steps), int(cfg.env.num_envs)
        seed_state = {k: v.detach().clone() for k, v in
                      build_agent(fabric("cpu", "32-true"), dims, cont, cfg, obs_space).state_dict().items()}
        host = {k: rng.integers(0, 256, (T, B, *obs_space[k].shape), dtype=np.uint8) for k in cnn}
        host.update({k: rng.standard_normal((T, B, *obs_space[k].shape)).astype(np.float32) for k in mlp})
        host["actions"] = np.stack([rng.integers(0, d, (T, B)) for d in dims], -1).astype(np.float32)
        host["rewards"] = rng.standard_normal((T, B, 1)).astype(np.float32)
        host["dones"] = (rng.random((T, B, 1)) < 0.05).astype(np.float32)
        host["logprobs"] = (np.log(1.0 / dims[0]) + 0.3 * rng.standard_normal((T, B, 1))).astype(np.float32)
        last = {k: rng.integers(0, 256, (B, *obs_space[k].shape), dtype=np.uint8) for k in cnn}
        last.update({k: rng.standard_normal((B, *obs_space[k].shape)).astype(np.float32) for k in mlp})
        carry = tuple(np.tanh(rng.standard_normal((B, int(cfg.algo.rnn.lstm.hidden_size)))).astype(np.float32)
                      for _ in range(2)) if kind == "recurrent" else None
        last_values = rng.standard_normal(B).astype(np.float32)

        def make(device, precision):
            agent = build_agent(fabric(device, precision), dims, cont, cfg, obs_space,
                                {k: v.clone() for k, v in seed_state.items()})
            optimizer = build_optimizer(agent.parameters(), CARD_PARITY_SGD, cfg.algo.max_grad_norm)
            if kind == "recurrent":
                trainer = RecurrentPPOTrainer(cfg, agent, optimizer, dims, cont, T, B)
                perms = [torch.randperm(B, generator=torch.Generator().manual_seed(e)).to(device)
                         for e in range(trainer.update_epochs)]
                perms = [torch.cat([p, p[:trainer.num_minibatches * trainer.env_bs - B]]) for p in perms]
                is_first = np.concatenate([np.ones((1, B, 1)), host["dones"][:-1]], 0).astype(np.float32)
                prev = np.concatenate([np.zeros((1, B, dims[0]), np.float32),
                                       np.eye(dims[0], dtype=np.float32)[host["actions"][:-1, :, 0].astype(int)]], 0)
                rollout = {**{k: torch.from_numpy(host[k]).to(device) for k in mlp},
                           "actions": torch.from_numpy(host["actions"]).to(device),
                           "prev_actions": torch.from_numpy(prev * (1.0 - is_first)).to(device),
                           "is_first": torch.from_numpy(is_first).to(device),
                           **{k: torch.from_numpy(host[k][..., 0]).to(device)
                              for k in ("rewards", "dones", "logprobs")}}

                def run():
                    return trainer.train_phase(rollout, tuple(torch.from_numpy(c).to(device) for c in carry),
                                               torch.from_numpy(last_values).to(device), perms, 0.01)
            else:
                trainer = (A2CTrainer if name == "a2c" else PPOTrainer)(cfg, agent, optimizer, cnn + mlp, dims, cont,
                                                                         T, B)
                perms = None if name == "a2c" else [  # A2C takes the whole rollout in one step
                    epoch_permutation(torch.Generator().manual_seed(e), T, B, trainer.batch_size,
                                      trainer.num_minibatches).to(device) for e in range(trainer.update_epochs)]
                rollout, last_obs = rollout_to_device(host, cnn, mlp, device), prepare_obs(last, cnn, mlp, device)

                def run():
                    return trainer.train_phase(rollout, last_obs, perms, 0.1, 0.01)
            return (lambda: {k: v.detach().cpu() for k, v in agent.state_dict().items()}), run, seed_state
        return make
    if kind == "off_policy":
        from sheeprl_tpu_torch.algos.droq.agent import build_agent as droq_agent
        from sheeprl_tpu_torch.algos.sac.agent import build_agent as sac_agent
        from sheeprl_tpu_torch.algos.sac.sac import SACTrainer
        from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent as sac_ae_agent
        from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAETrainer

        build = {"sac": sac_agent, "droq": droq_agent, "sac_ae": sac_ae_agent}[name]
        trainer_cls = SACAETrainer if name == "sac_ae" else SACTrainer
        groups = ("actor", "critic", "alpha", "encoder", "decoder")[:5 if name == "sac_ae" else 3]
        U, B = 2, 64
        act_dim = int(np.prod(act_space.shape))
        host = {"actions": rng.uniform(-0.99, 0.99, (U, B, act_dim)).astype(np.float32),
                "rewards": rng.standard_normal((U, B)).astype(np.float32),
                "terminated": (rng.random((U, B)) < 0.1).astype(np.float32)}
        if name == "sac_ae":
            agent_input = obs_space
            for k in ("rgb", "next_rgb"):
                host[k] = rng.integers(0, 256, (U, B, *obs_space["rgb"].shape), dtype=np.uint8)
        else:
            agent_input = int(sum(np.prod(obs_space[k].shape) for k in mlp))
            for k in ("obs", "next_obs"):
                host[k] = rng.standard_normal((U, B, agent_input)).astype(np.float32)
        seed_state = {k: v.detach().clone() for k, v in
                      build(fabric("cpu", "32-true"), act_dim, cfg, agent_input).state_dict().items()}
        probe = trainer_cls(cfg, build(fabric("cpu", "32-true"), act_dim, cfg, agent_input, seed_state), {}, act_dim)
        noise_gen = torch.Generator().manual_seed(47)
        noise = [probe.draw_noise(B, noise_gen) for _ in range(U)]

        def make(device, precision):
            run_cfg = sgd(copy.deepcopy(cfg), groups)
            agent = build(fabric(device, precision), act_dim, run_cfg, agent_input,
                          {k: v.clone() for k, v in seed_state.items()})
            trainer = trainer_cls(run_cfg, agent, trainer_cls.build_optimizers(run_cfg, agent), act_dim)
            batches = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
            dev_noise = _to_device(noise, device)

            def run():
                return trainer.train_phase(batches, dev_noise, 0)
            return (lambda: {k: v.detach().cpu() for k, v in agent.state_dict().items()}), run, seed_state
        return make
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent as dv1_agent
    from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import DV1Trainer
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import DV2Trainer
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import build_agent as dv2_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import blocks_to_device, build_dv3_optimizers, draw_noise

    build, trainer_cls = (dv2_agent, DV2Trainer) if name == "dreamer_v2" else (dv1_agent, DV1Trainer)
    L, B, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size), int(cfg.algo.horizon)
    block = {"rgb": rng.integers(0, 256, (1, L, B, *obs_space["rgb"].shape), dtype=np.uint8),
             "state": rng.standard_normal((1, L, B, 4)).astype(np.float32),
             "actions": np.eye(dims[0], dtype=np.float32)[rng.integers(0, dims[0], (1, L, B))],
             "rewards": rng.standard_normal((1, L, B, 1)).astype(np.float32),
             "terminated": (rng.random((1, L, B, 1)) < 0.02).astype(np.float32),
             "is_first": (rng.random((1, L, B, 1)) < 0.02).astype(np.float32)}
    seed_modules = build(fabric("cpu", "32-true"), dims, cont, cfg, obs_space)
    seed_state = {n: {k: v.detach().clone() for k, v in m.state_dict().items()} for n, m in seed_modules.items()}
    noise = draw_noise(seed_modules["world_model"], seed_modules["actor"], 1, L, B, H,
                       torch.Generator().manual_seed(47))
    del seed_modules

    def make(device, precision):
        run_cfg = sgd(copy.deepcopy(cfg), ("world_model", "actor", "critic"))
        modules = build(fabric(device, precision), dims, cont, run_cfg, obs_space,
                        {n: {k: v.clone() for k, v in s.items()} for n, s in seed_state.items()})
        trainer = trainer_cls(run_cfg, modules, build_dv3_optimizers(run_cfg, modules), cnn, mlp, cont)
        blocks, dev_noise = blocks_to_device(block, cnn, mlp, device), _to_device(noise, device)

        def run():
            return trainer.train_phase(blocks, dev_noise, 0)
        def state_of():
            return {f"{n}.{k}": v.detach().cpu() for n, m in modules.items() for k, v in m.state_dict().items()}
        return state_of, run, {f"{n}.{k}": v for n, s in seed_state.items() for k, v in s.items()}
    return make


def _family_gaps(start, got, ref, losses, ref_losses, dreamer: bool) -> dict:
    """``got`` against ``ref`` (flat state dicts after one phase from
    ``start``): the losses' relative differences and each top module's
    relative L2 difference of the parameter changes."""
    groups = {}
    for k, r in ref.items():
        top = k.split(".")[0]
        jd, pd = (r - start[k]).double(), (got[k] - start[k]).double()
        num, den = groups.get(top, (0.0, 0.0))
        groups[top] = (num + float(((pd - jd) ** 2).sum()), den + float((jd ** 2).sum()))
    l2 = {top: float(np.sqrt(n / d)) if d > 0 else 0.0 for top, (n, d) in groups.items()}
    rel = np.abs(losses - ref_losses) / np.maximum(np.abs(ref_losses), 1e-6)
    if dreamer:
        wm = [0, 1, 2, 3, 4, 5, 8, 9]
        t = PRECISION_DREAMER_TIER
        ok = bool(np.all(rel[wm] <= t["wm_metric_rel"]) and np.all(
            np.abs(losses - ref_losses)[6:8] <= t["behaviour_metric_rel"] * np.abs(ref_losses[6:8])
            + t["behaviour_metric_abs"]) and all(
            v <= (t["world_model_l2"] if top == "world_model" else t["behaviour_l2"]) for top, v in l2.items()
            if "target" not in top))
    else:
        t = PRECISION_FAMILY_TIER
        ok = bool(np.all(np.abs(losses - ref_losses) <= t["loss_rel"] * np.abs(ref_losses) + t["loss_abs"])
                  and all(v <= t["change_l2"] for v in l2.values()))
    return {"ok": ok, "loss_rel": rel.tolist(), "change_l2": l2}


def phase_precision_families(torch) -> dict:
    """Phase 47: :data:`PRECISION_FAMILIES`, each one train phase under
    bf16-mixed on the card against the same phase on the CPU (the gate), the
    CPU's bf16 against its fp32 beside it (what bf16 itself moves); then the
    card's phase timed under bf16-mixed and 32-true in turns (bf16, fp32,
    fp32, bf16)."""
    out = {}
    for name, (overrides, kind) in PRECISION_FAMILIES.items():
        t0 = time.perf_counter()
        make = _family_case(torch, name, overrides, kind)
        results = {}
        for device, precision in (("cpu", "bf16-mixed"), ("cpu", "32-true"), (CARD, "bf16-mixed")):
            state_of, run, start = make(device, precision)
            losses = np.array([float(x) for x in run()])
            results[device, precision] = (state_of(), losses)
        (cpu_b, cpu_bl), (cpu_f, cpu_fl), (card_b, card_bl) = (results[k] for k in (
            ("cpu", "bf16-mixed"), ("cpu", "32-true"), (CARD, "bf16-mixed")))
        dreamer = kind == "dreamer"
        gate = _family_gaps(start, card_b, cpu_b, card_bl, cpu_bl, dreamer)
        effect = _family_gaps(start, cpu_b, cpu_f, cpu_bl, cpu_fl, dreamer)
        runs = {p: make(CARD, p)[1] for p in ("bf16-mixed", "32-true")}
        for fn in runs.values():
            fn()  # cuDNN's algorithm choice and the first launches
        turns = _turns(torch, runs, order=("bf16-mixed", "32-true", "32-true", "bf16-mixed"))
        per = {"on_policy": 1, "recurrent": 1, "off_policy": 2, "dreamer": 1}[kind]
        rates = {p: [per / s for s in v["s"]] for p, v in turns.items()}
        unit = "train phases/s (one iteration's update)" if per == 1 and not dreamer else "updates/s"
        log(f"[precision-{name}] one train phase under bf16-mixed, card vs CPU: losses rel diff "
            f"{', '.join(f'{x:.2e}' for x in gate['loss_rel'])}, changes rel L2 "
            f"{', '.join(f'{k} {v:.3g}' for k, v in gate['change_l2'].items())}; the CPU's bf16 vs its fp32: losses "
            f"{', '.join(f'{x:.2e}' for x in effect['loss_rel'])}, changes "
            f"{', '.join(f'{k} {v:.3g}' for k, v in effect['change_l2'].items())}; on the card in turns (bf16, fp32, "
            f"fp32, bf16) {rates['bf16-mixed'][0]:.2f}, {rates['32-true'][0]:.2f}, {rates['32-true'][1]:.2f}, "
            f"{rates['bf16-mixed'][1]:.2f} {unit}; {time.perf_counter() - t0:.1f} s")
        if not (gate["ok"] and np.isfinite(card_bl).all()):
            raise AssertionError(f"{name}: the bf16 train phase on the card disagrees with the CPU's beyond the tier")
        out[name] = {"gate": gate, "bf16_effect": effect, "rates": rates, "unit": unit}
        del runs, results
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_precision(torch, run_root: Path, fp32: dict, families: bool = True) -> dict:
    """Phases 42-47.  ``fp32`` holds this run's 32-true readings of the same
    paths (phases 7, 11 and 38-39), each printed beside its bf16 one, and
    under ``"bf16"`` phases 43-44 where phase_graphs ran them (else they run
    here, beside light 32-true windows); without ``families``, phase 47 is
    left to the caller."""
    t0 = time.perf_counter()
    out = {"kernels": phase_precision_kernels(torch)}
    train = _train(torch, [*XL_TRAIN, *XL_TRAIN_STEPS, FUSED, HOST_RING, BF16_MIXED], run_root / "train_xl_bf16",
                   "rssm")
    log(f"[precision-train] DreamerV3-XL under bf16-mixed through cli.run: {train['updates_per_s']:.3f} updates/s, "
        f"peak {train['peak_bytes'] / 2**30:.2f} GiB, rssm launches per update {sorted(set(train['per_update']))}; "
        f"32-true (phase 7): " + (f"{fp32['train']['updates_per_s']:.3f} updates/s, peak "
                                 f"{fp32['train']['peak_bytes'] / 2**30:.2f} GiB" if fp32.get("train") else "not run"))
    out["train"] = train
    for key, recipe, kernel in WINDOW_RECIPES:
        if fp32.get("bf16"):  # phases 43-44 ran beside phases 38-39 (phase_graphs)
            out[key] = fp32["bf16"][key]
        else:
            base = phase_graph_window(torch, f"graphs-{key.replace('_', '-')}", recipe, kernel, light=True, keep=True)
            try:
                out[key] = phase_precision_window(torch, key, recipe, kernel, base["built"])
            finally:
                _release(torch, base)
        out[f"{key}_turns"] = out[key].pop("turns")
    from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import P2EDV3Trainer

    p2e = _train(torch, [*P2E_XL, BF16_MIXED], run_root / "p2e_explore_bf16", "rssm", P2E_LAUNCHES_PER_UPDATE,
                 trainer_cls=P2EDV3Trainer, snapshot=False)
    p2e.pop("trainer")
    if len(p2e["intrinsic"]) != p2e["updates"]:
        raise AssertionError(f"P2E bf16: intrinsic rewards {p2e['intrinsic']} for {p2e['updates']} updates")
    log(f"[precision-p2e] P2E-DV3-XL exploration under bf16-mixed: {p2e['updates_per_s']:.3f} updates/s, peak "
        f"{p2e['peak_bytes'] / 2**30:.2f} GiB, rssm launches per update {sorted(set(p2e['per_update']))}; 32-true "
        + (f"(phase 11): {fp32['p2e']['updates_per_s']:.3f} updates/s, peak {fp32['p2e']['peak_bytes'] / 2**30:.2f} GiB"
           if fp32.get("p2e") else "not run"))
    out["p2e"] = p2e
    out["serve"] = phase_precision_serve(torch, train["snapshot"])
    if families:
        out["families"] = phase_precision_families(torch)
    for key in ("dv3_xl", "dv3_s_gru"):
        if fp32.get(key):
            bf16 = out[key]["updates_per_s"]["graph"]
            log(f"[precision] {key}: replayed updates/s bf16 {', '.join(f'{x:.3f}' for x in bf16)}"
                f" against 32-true (phase {38 if key == 'dv3_xl' else 39}) "
                f"{', '.join(f'{x:.3f}' for x in fp32[key]['updates_per_s']['graph'])}; peak "
                f"{out[key]['peak_bytes'] / 2**30:.2f} against {fp32[key]['peak_bytes'] / 2**30:.2f} GiB")
    out["seconds"] = time.perf_counter() - t0
    log(f"[precision] phases 42-47: {out['seconds']:.1f} s")
    return out


def precision_summary(p: dict) -> dict:
    keep = ("updates_per_s", "host_ms_per_update", "device_ms_per_update", "captures", "peak_bytes",
            "launches_per_update", "loss_rel", "param_abs")
    train_keep = ("updates", "updates_per_s", "updates_per_s_events", "first_update_s", "peak_bytes", "per_update")
    return {"kernels": p["kernels"], "train": {k: p["train"][k] for k in train_keep},
            "p2e": {k: p["p2e"][k] for k in train_keep},
            **{k: {x: p[k][x] for x in keep} for k in ("dv3_xl", "dv3_s_gru")},
            "dv3_xl_turns": p["dv3_xl_turns"], "dv3_s_gru_turns": p["dv3_s_gru_turns"], "serve": p["serve"],
            "families": p["families"], "seconds": p["seconds"]}


# -- the runtime services (phases 48-50) ------------------------------------------
def phase_runtime_guard(torch, tag: str, overrides, kernel: str) -> dict:
    """Phase 48: phase 38's chunk (39's for S) with the health guard inside
    the captured window, from one state and generator state under cuDNN's
    deterministic algorithms: the unguarded window (``health.enabled=False``)
    replayed once; the guarded one, built under a planted ``update.grads
    nonfinite at=2``, called three times (the first call eager, then
    captured; the second replayed and poisoned, so skipped; the third
    replayed clean), every replay inside ``steady_guard`` (a host read
    raises); then unguarded and guarded replays in turns (the guarded graph
    carries the planted fault's predicate, one ``torch.where`` per parameter
    that selects it unchanged)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import prep_blocks
    from sheeprl_tpu_torch.data.device_replay import fused_sequence_train, steady_guard
    from sheeprl_tpu_torch.ops import gru, rssm
    from sheeprl_tpu_torch.parallel.compile import GraphFunction
    from sheeprl_tpu_torch.resilience import faults
    from sheeprl_tpu_torch.resilience.health import HealthSentinel
    from sheeprl_tpu_torch.telemetry.monitors import CompileMonitor

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counter_of = {"rssm": rssm.LAUNCHES, "gru": gru.LAUNCHES}[kernel]
    cfg, trainer, rb = _fresh_window(torch, overrides, seed=48)
    L, B = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size)
    dev = trainer.device
    gen = torch.Generator(dev).manual_seed(48)

    def window(n, counter):
        return fused_sequence_train(trainer, rb, gen, B, L, n,
                                    lambda b: prep_blocks(b, trainer.cnn_keys, trainer.mlp_keys), counter)

    trainer.guarded_state()  # the optimizers' state made before the first step, as the loop's guard makes it
    start, g_start = trainer.snapshot(), gen.get_state()
    counter0 = torch.full((), 1, dtype=torch.int64, device=dev)

    def compiled(fn, name):
        return GraphFunction(fn, name=f"{tag}.{name}", static_argnums=(0,), device=dev, generators=(gen,),
                             monitor=CompileMonitor())

    def run(f, replay: bool = True):
        trainer.restore(start)
        gen.set_state(g_start)
        before = counter_of[kernel]
        with steady_guard(replay):
            _, metrics = f(GRAPH_CHUNK, counter0)
        torch.cuda.synchronize()
        params, opt = trainer.guarded_state()
        return {"metrics": np.array([float(m) for m in metrics]), "launches": counter_of[kernel] - before,
                "state": [t.detach().clone() for t in (*params, *opt)]}

    def guarded_by(sentinel, name):
        return compiled(sentinel.wrap(window, trainer.guarded_state, dev), name)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = compiled(window, "train_phase_device")
        run(plain, replay=False)  # the first call: eager, then captured
        u1 = run(plain)
        torch.cuda.synchronize()
        peak_plain = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        faults.install_plan(faults.FaultPlan.from_specs([{"site": "update.grads", "kind": "nonfinite", "at": 2}]))
        try:
            sentinel = HealthSentinel.from_config(cfg)  # resolves the plan now
        finally:
            faults.clear_plan()
        guarded = guarded_by(sentinel, "train_phase_device_guarded")
        run(guarded, replay=False)  # guarded window 1: eager, then captured; applied
        p2 = run(guarded)  # window 2, replayed: poisoned, skipped
        g = run(guarded)  # window 3, replayed: applied
        torch.cuda.synchronize()
        peak_guarded = torch.cuda.max_memory_allocated()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    sentinel.poll(0)
    health = sentinel.metrics()
    bit = [i for i, (a, b) in enumerate(zip(u1["state"], g["state"])) if torch.equal(a, b)]
    worst = max(float((a.double() - b.double()).abs().max()) for a, b in zip(u1["state"], g["state"]))
    skipped_equal = sum(torch.equal(a, b) for a, b in zip(p2["state"], [t for t in start_state(trainer, start)]))
    expected = LAUNCHES_PER_UPDATE * GRAPH_CHUNK
    n = len(u1["state"])
    log(f"[{tag}] one chunk of {GRAPH_CHUNK} updates, cuDNN deterministic, replays under steady_guard: guarded vs "
        f"unguarded {len(bit)} of {n} trained tensors bit for bit (max abs diff {worst:.3g}), losses bit for bit "
        f"{int((g['metrics'] == u1['metrics']).sum())} of 10; "
        f"planted nonfinite window 2: {skipped_equal} of {n} tensors equal to its input, Health/skipped "
        f"{health['Health/skipped']:.0f} of {health['Health/windows']:.0f} windows; {kernel} "
        f"launches per replay unguarded {u1['launches']}, guarded {g['launches']} "
        f"({expected // GRAPH_CHUNK} per update)")
    # every tensor and loss bit for bit (phase 38 found two deterministic
    # replays equal in all of them)
    if not (len(bit) == n and np.array_equal(g["metrics"], u1["metrics"]) and skipped_equal == n
            and health["Health/skipped"] == 1 and health["Health/windows"] == 3
            and u1["launches"] == g["launches"] == expected):
        raise AssertionError(f"{tag}: the guarded window disagrees with the unguarded one, or the planted "
                             "nonfinite window was not skipped bit for bit")
    turns = _turns(torch, {"unguarded": lambda: plain(GRAPH_CHUNK, counter0),
                           "guarded": lambda: guarded(GRAPH_CHUNK, counter0)},
                   order=("unguarded", "guarded", "guarded", "unguarded"))
    ups = {k: [GRAPH_CHUNK * GRAPH_TURN_CHUNKS / t for t in v["s"]] for k, v in turns.items()}
    backup = sum(b.numel() * b.element_size() for b in sentinel._backup)
    out = {"updates_per_s": ups, "peak_bytes": {"unguarded": peak_plain, "guarded": peak_guarded},
           "backup_bytes": backup, "launches_per_update": g["launches"] // GRAPH_CHUNK,
           "bit_for_bit": len(bit), "tensors": n}
    log(f"[{tag}] updates/s in turns unguarded {ups['unguarded'][0]:.3f}, guarded {ups['guarded'][0]:.3f}, guarded "
        f"{ups['guarded'][1]:.3f}, unguarded {ups['unguarded'][1]:.3f}; peak device memory unguarded "
        f"{peak_plain / 2**30:.2f} GiB, guarded {peak_guarded / 2**30:.2f} GiB (the guard's backup "
        f"{backup / 2**30:.2f} GiB)")
    del plain, guarded, trainer, rb, start
    gc.collect()
    torch.cuda.empty_cache()
    return out


def start_state(trainer, snap):
    """The trained tensors of ``snap`` (a ``trainer.snapshot()``) in the order
    of ``trainer.guarded_state()``."""
    trainer.restore(snap)
    params, opt = trainer.guarded_state()
    return [t.detach().clone() for t in (*params, *opt)]


PREEMPT_DIR = "preempt"
# phase 7's XL recipe (fused RSSM kernel, captured) on the card's ring, cut to
# 4096 steps and kept in the snapshot: the first window at step 65 is 8
# updates, chunks of 4 (the first captured, the second replayed); the run
# ends only when preempted
PREEMPT_XL = (*XL_TRAIN, FUSED, "buffer.checkpoint=True", "algo.replay_ratio=0.125", "algo.total_steps=1000000",
              "algo.run_test=False", f"root_dir={PREEMPT_DIR}")


@contextlib.contextmanager
def _window_log(emit):
    """Inside the block, each call of a loop's train window is reported to
    ``emit``: its updates, whether it replayed an entry built earlier, and
    the kernel launches it made (or was credited with)."""
    from sheeprl_tpu_torch.ops import gru, rssm
    from sheeprl_tpu_torch.parallel.compile import GraphFunction

    call = GraphFunction.__call__

    def logged(self, *args, **kwargs):
        if not self.name.endswith(WINDOW_NAMES):
            return call(self, *args, **kwargs)
        entries, before = self.cache_size(), (rssm.LAUNCHES["rssm"], gru.LAUNCHES["gru"])
        out = call(self, *args, **kwargs)
        emit({"updates": int(args[0]), "replayed": self.cache_size() == entries,
              "rssm": rssm.LAUNCHES["rssm"] - before[0], "gru": gru.LAUNCHES["gru"] - before[1]})
        return out

    GraphFunction.__call__ = logged
    try:
        yield
    finally:
        GraphFunction.__call__ = call


def preempt_child(torch, argv) -> int:
    """``--preempt-child OVERRIDES``: ``cli.run`` with each call of the train
    window logged on a line, for phase 49's parent to read."""
    from sheeprl_tpu_torch.cli import run

    with _window_log(lambda w: log("[child] window " + json.dumps(w))):
        run(list(argv))
    return 0


def commit_hang_child(torch, root: str) -> int:
    """``--commit-hang-child DIR``: phase 49's hung final commit, without a
    training run: a checkpoint manager with ``save_on_preemption`` arms the
    latch, says so on a line, waits for SIGTERM, then saves a state
    synchronously as a preempted loop does; its commit hangs under the
    planted ``checkpoint.commit`` plan (``SHEEPRL_FAULT_PLAN``) until a
    second SIGTERM ends the process."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.resilience.faults import install_from_env
    from sheeprl_tpu_torch.utils.structured import dotdict

    install_from_env()
    mgr = CheckpointManager(dotdict({"checkpoint": {"every": 0, "save_last": False}}), root)
    mgr.should_save(TORN_STEP, 0)  # arms the latch
    log("[child] ready")
    while not mgr.should_save(TORN_STEP, 0):
        time.sleep(0.05)
    mgr.save(TORN_STEP, {"w": torch.arange(1 << 20, dtype=torch.float32)})
    return 0


#: the hung commit's step: above every step the preempted runs commit
TORN_STEP = 10**9


def _child(overrides, log_dir: Path, env=None):
    return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--preempt-child", *overrides,
                             f"log_dir={log_dir}"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env={**os.environ, **(env or {})})


def _read_lines(proc, lines: list, seen: threading.Event, marker) -> threading.Thread:
    def reader():
        for line in proc.stdout:
            lines.append(line)
            if marker(line):
                seen.set()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    return t


def _replayed(line: str) -> bool:
    return line.startswith("[child] window ") and json.loads(line[len("[child] window "):])["replayed"]


def _preempt(tag: str, proc, timeout: float = 300.0, usr1_dir: Path = None, meanwhile=None) -> dict:
    """SIGTERM ``proc`` after its first replayed window; its exit code, its
    output and the wall time the signal was sent.  With ``usr1_dir``, a
    SIGUSR1 first, as soon as that window is seen: the next dispatch opens a
    trace window (phase 52), and the SIGTERM waits until the dispatch after
    it has run (its tick closed and wrote the trace) and a ``trace.json`` is
    under ``usr1_dir``.  A helper thread sends both signals, so the child is
    preempted and commits while ``meanwhile()`` runs in this thread."""
    lines, seen = [], threading.Event()
    reader = _read_lines(proc, lines, seen, _replayed)
    usr1 = None if usr1_dir is None else {}
    sent = {}

    def signal_child():
        try:
            if not seen.wait(timeout):
                raise AssertionError(f"[{tag}] no replayed window within {timeout} s:\n{''.join(lines)[-4000:]}")
            if usr1_dir is not None:
                if proc.poll() is None:
                    usr1["windows_before"] = len(_windows("".join(lines)))
                    proc.send_signal(signal.SIGUSR1)
                deadline = time.monotonic() + timeout
                while not ("windows_before" in usr1 and len(_windows("".join(lines))) >= usr1["windows_before"] + 2
                           and list(usr1_dir.glob("**/trace/*/trace.json"))):
                    if time.monotonic() > deadline or proc.poll() is not None:
                        raise AssertionError(f"[{tag}] SIGUSR1 opened no trace window:\n{''.join(lines)[-4000:]}")
                    time.sleep(0.1)
                usr1["windows_after"] = len(_windows("".join(lines)))
            sent["t_signal"] = time.time()
            proc.send_signal(signal.SIGTERM)
        except BaseException as e:  # noqa: BLE001 - raised again in the calling thread
            sent["error"] = e

    signaller = threading.Thread(target=signal_child, daemon=True)
    signaller.start()
    try:
        if meanwhile is not None:
            meanwhile()
        signaller.join(2 * timeout)
        if "error" in sent:
            raise sent["error"]
        if "t_signal" not in sent:
            raise AssertionError(f"[{tag}] the child was not signalled within {2 * timeout} s")
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(10)
    return {"rc": rc, "out": "".join(lines), "t_signal": sent["t_signal"], "usr1": usr1}


def _windows(out: str) -> list:
    return [json.loads(line[len("[child] window "):]) for line in out.splitlines()
            if line.startswith("[child] window ")]


def _committed(log_dir: Path, min_step: int = -1) -> list:
    """The committed snapshots of the preemption runs under ``log_dir``, oldest commit first."""
    from sheeprl_tpu_torch.checkpoint.protocol import checkpoint_step, list_checkpoints

    dirs = [d for root in log_dir.glob(f"{PREEMPT_DIR}/*/version_*/checkpoint") for d in list_checkpoints(root)]
    return sorted((d for d in dirs if checkpoint_step(d) > min_step), key=lambda d: (d / "COMMIT").stat().st_mtime)


def _start_crash_child(log_dir: Path) -> tuple:
    """Phase 52's planted raise (``checkpoint.write_shard``) in a small
    DreamerV3 run, started in a process of its own, its output to a file:
    ``(process, log_dir, output path)``."""
    log_dir.mkdir(parents=True, exist_ok=True)
    output = log_dir / "output.log"
    plan = json.dumps({"plan": [{"site": "checkpoint.write_shard", "kind": "raise", "at": 1}]})
    with open(output, "w") as f:
        proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--preempt-child", *REPLAY_DV3_SMALL,
                                 "algo.total_steps=64", "checkpoint.io_retries=1", f"log_dir={log_dir}"], cwd=ROOT,
                                stdout=f, stderr=subprocess.STDOUT, text=True,
                                env={**os.environ, "SHEEPRL_FAULT_PLAN": plan})
    return proc, log_dir, output


def _preempted_xl(torch, log_dir: Path, meanwhile=None) -> tuple:
    """Phase 49's preempted DV3-XL child (``PREEMPT_XL``): a SIGUSR1 after its
    first replayed window (phase 52: one trace window of the live run), then
    the SIGTERM; exit 0, one committed snapshot that ``verify_checkpoint``
    passes.  Phase 52's planted raise (:func:`_start_crash_child`) runs
    beside it.  Returns the child's record (with the seconds from the signal
    to the commit, and the planted raise's process under ``"crash"``) and
    the committed step directory."""
    from sheeprl_tpu_torch.checkpoint.protocol import verify_checkpoint

    crash = _start_crash_child(log_dir.parent / "crash")
    try:
        first = _preempt("preempt", _child(PREEMPT_XL, log_dir), usr1_dir=log_dir, meanwhile=meanwhile)
    except BaseException:
        crash[0].kill()
        crash[0].wait()
        raise
    first["crash"] = crash
    if first["rc"] != 0 or "Preemption: committed checkpoint" not in first["out"]:
        raise AssertionError(f"[preempt] rc {first['rc']}:\n{first['out'][-4000:]}")
    (saved_dir,) = _committed(log_dir)
    problems = verify_checkpoint(saved_dir)
    first["signal_to_commit_s"] = (saved_dir / "COMMIT").stat().st_mtime - first["t_signal"]
    first_windows = _windows(first["out"])
    log(f"[preempt] DV3-XL preempted after {len(first_windows)} window calls "
        f"({sum(w['updates'] for w in first_windows)} updates, rssm {sum(w['rssm'] for w in first_windows)}; "
        f"SIGUSR1 after window call {first['usr1']['windows_before']}): exit {first['rc']}, committed "
        f"{saved_dir.name} {first['signal_to_commit_s']:.2f} s after the SIGTERM, verify_checkpoint "
        f"{problems or 'passes'}")
    if problems:
        raise AssertionError(f"[preempt] {saved_dir}: {problems}")
    return first, saved_dir


def phase_runtime_preempt(torch, run_root: Path, meanwhile=None) -> dict:
    """Phase 49: ``cli.run`` of DV3-XL (fused RSSM kernel, captured, the
    card's ring cut to 4096 steps) in a subprocess, SIGTERM after its first
    replayed window: exit 0 and one committed snapshot that
    ``verify_checkpoint`` passes; ``checkpoint.resume_from=auto`` (a run 8
    steps long, in this process) continues the counters, generators and
    ring cursor and launches the RSSM kernel in its first window; then a
    process whose
    preempted save's commit hangs (a planted ``checkpoint.commit`` hang) is
    killed by a second SIGTERM, and its torn step, above every committed
    one, is never chosen on resume.  That process starts first and waits
    for its signal meanwhile."""
    log_dir = run_root / "preempt"
    plan = json.dumps({"plan": [{"site": "checkpoint.commit", "kind": "hang", "at": 1, "seconds": 120}]})
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--commit-hang-child",
                             str(log_dir / PREEMPT_DIR / "commit_hang" / "version_0")], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "SHEEPRL_FAULT_PLAN": plan})
    lines, seen = [], threading.Event()
    reader = _read_lines(proc, lines, seen, lambda line: line.startswith("[child] ready"))
    try:
        return _runtime_preempt(torch, log_dir, proc, lines, seen, meanwhile)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(10)


def _runtime_preempt(torch, log_dir: Path, proc, lines: list, seen: threading.Event, meanwhile=None) -> dict:
    """Phase 49 (:func:`phase_runtime_preempt`), the hung commit's process
    ``proc`` started, its output read into ``lines``."""
    from sheeprl_tpu_torch.checkpoint.manager import resolve_auto_resume
    from sheeprl_tpu_torch.checkpoint.protocol import (
        checkpoint_step,
        is_committed,
        list_checkpoints,
        load_step_dir,
        verify_checkpoint,
    )

    def committed(min_step=-1):
        return _committed(log_dir, min_step)

    first, saved_dir = _preempted_xl(torch, log_dir, meanwhile)
    saved = load_step_dir(saved_dir, map_location="cpu")
    first_windows = _windows(first["out"])
    to_commit = first["signal_to_commit_s"]

    # the resumed run, in this process: it trains at once (learning_starts 1)
    # and ends 8 steps on, one window of 1 update, then its final save
    from sheeprl_tpu_torch.cli import run

    chosen_first = resolve_auto_resume(log_dir, PREEMPT_DIR)
    resumed_windows = []
    with _window_log(resumed_windows.append):
        run([*PREEMPT_XL, "checkpoint.resume_from=auto", "algo.learning_starts=1",
             f"algo.total_steps={int(saved['policy_step']) + 8}", f"log_dir={log_dir}"])
    gc.collect()
    torch.cuda.empty_cache()
    if chosen_first != saved_dir:
        raise AssertionError(f"[resume] resume_from=auto chose {chosen_first}, not {saved_dir}")
    resumed_dir = committed(saved["policy_step"])[-1]
    resumed = load_step_dir(resumed_dir, map_location="cpu")
    k = int(resumed["update"]) - int(saved["update"])
    cap = int(saved["rb"]["buffer_size"])
    fresh = torch.Generator().manual_seed(5).get_state()
    chained = {
        "policy_step": resumed["policy_step"] == saved["policy_step"] + k * int(saved["rb"]["n_envs"]),
        "ring cursor": bool(np.array_equal(np.asarray(resumed["rb"]["pos"]),
                                           (np.asarray(saved["rb"]["pos"]) + k) % cap)),
        "ring rows": all(np.array_equal(np.asarray(resumed["rb"]["buffer"][key])[: int(saved["rb"]["pos"][0]) - 1],
                                        np.asarray(saved["rb"]["buffer"][key])[: int(saved["rb"]["pos"][0]) - 1])
                         for key in ("rgb", "actions")),
        "grad steps": resumed["grad_steps"] > saved["grad_steps"],
        "generators": not torch.equal(resumed["generators"]["train"], saved["generators"]["train"])
        and not torch.equal(saved["generators"]["train"], fresh),
        "first window launches the kernel": bool(resumed_windows) and resumed_windows[0]["rssm"]
        == LAUNCHES_PER_UPDATE * resumed_windows[0]["updates"] > 0,
    }
    log(f"[resume] resumed from {saved_dir.name}: {k} iterations on, its final save {resumed_dir.name}; "
        + ", ".join(f"{name} {ok}" for name, ok in chained.items())
        + f"; first window {resumed_windows[0] if resumed_windows else None}")
    if not all(chained.values()):
        raise AssertionError(f"[resume] the resumed run does not continue the saved one: {chained}")

    if not seen.wait(120):
        raise AssertionError(f"[torn] the child never armed its latch:\n{''.join(lines)[-4000:]}")
    proc.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + 120
    torn = []
    while not torn and time.monotonic() < deadline:
        torn = [d for d in log_dir.glob(f"{PREEMPT_DIR}/*/version_*/checkpoint/step_*")
                if (d / "shard_r00000.meta.json").exists() and not is_committed(d)]
        time.sleep(0.1)
    if not torn:
        raise AssertionError(f"[torn] the final save never reached its commit:\n{''.join(lines)[-4000:]}")
    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=60)
    killed_s = time.perf_counter() - t0
    chosen = resolve_auto_resume(log_dir, PREEMPT_DIR)
    log(f"[torn] a preempted save's commit hung; the second SIGTERM ended it in {killed_s:.2f} s with rc {rc}; "
        f"torn {torn[0].name} committed {is_committed(torn[0])}; resume_from=auto chooses {chosen}")
    if rc != -signal.SIGTERM or is_committed(torn[0]) or chosen != resumed_dir:
        raise AssertionError(f"[torn] rc {rc}, chosen {chosen}:\n{''.join(lines)[-4000:]}")
    return {"signal_to_commit_s": to_commit, "preempted_updates": sum(w["updates"] for w in first_windows),
            "first": first, "saved_dir": saved_dir,
            "preempted": {n: sum(w[n] for w in first_windows) for n in ("rssm", "gru")},
            "resumed": {n: sum(w[n] for w in resumed_windows) for n in ("rssm", "gru")},
            "resumed_first_window_per_update": {n: resumed_windows[0][n] // resumed_windows[0]["updates"]
                                                for n in ("rssm", "gru")},
            "killed_s": killed_s}


def phase_runtime_faults(torch, run_root: Path, served_dir: Path) -> dict:
    """Phase 50: a planted ``checkpoint.commit`` hang past a short
    ``hang_warn_s`` gives one watchdog stall; a ``checkpoint.write_shard
    corrupt`` snapshot is quarantined on resume; a ``serve.http raise`` plan
    on the XL server loses no request (the client retries); a planted
    ``update.grads divergence`` rolls SAC back on the card to its committed
    snapshot, raises ``DivergenceError`` past the budget, and raises it in
    DreamerV3."""
    import warnings

    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.checkpoint.protocol import write_snapshot
    from sheeprl_tpu_torch.cli import resolve_resume_target, run
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.resilience import faults
    from sheeprl_tpu_torch.resilience.health import DivergenceError
    from sheeprl_tpu_torch.serve.client import PolicyClient
    from sheeprl_tpu_torch.serve.server import PolicyServer
    from sheeprl_tpu_torch.serve.service import PolicyService
    from sheeprl_tpu_torch.telemetry.monitors import RESILIENCE_MONITOR
    from sheeprl_tpu_torch.utils.structured import dotdict

    def install(*specs):
        faults.install_plan(faults.FaultPlan.from_specs(list(specs)))

    out = {}
    try:
        # the writer's watchdog
        stalls = RESILIENCE_MONITOR.totals()["stalls"]
        install({"site": "checkpoint.commit", "kind": "hang", "at": 1, "seconds": 1.0})
        mgr = CheckpointManager(dotdict({"checkpoint": {"async_save": True, "hang_warn_s": 0.2}}),
                                run_root / "watchdog")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mgr.save(1, {"w": torch.ones(1024, device=CARD)})
            mgr.finalize()
        out["watchdog_stalls"] = RESILIENCE_MONITOR.totals()["stalls"] - stalls
        stall_warnings = sum("no progress" in str(w.message) for w in caught)
        log(f"[faults] a 1.0 s commit hang under hang_warn_s 0.2: {out['watchdog_stalls']} watchdog stall, "
            f"{stall_warnings} warning, committed {mgr.latest() is not None}")
        if out["watchdog_stalls"] != 1 or stall_warnings != 1 or mgr.latest() is None:
            raise AssertionError("[faults] the writer's watchdog did not flag the hung commit once")

        # a corrupt shard, quarantined on resume
        root = run_root / "quarantine"
        ckpt = root / "q" / "run" / "version_0" / "checkpoint"
        faults.clear_plan()
        good = write_snapshot(ckpt, 1, {"w": torch.arange(4096.0)})
        time.sleep(0.05)  # discovery orders commits by time
        install({"site": "checkpoint.write_shard", "kind": "corrupt", "at": 1})
        bad = write_snapshot(ckpt, 2, {"w": torch.arange(4096.0)})
        faults.clear_plan()
        quarantined = RESILIENCE_MONITOR.totals()["quarantined"]
        cfg = resolve_resume_target(dotdict({"log_dir": str(root), "root_dir": "q",
                                             "checkpoint": {"resume_from": "auto"}}))
        out["quarantined"] = RESILIENCE_MONITOR.totals()["quarantined"] - quarantined
        log(f"[faults] resume_from=auto with a corrupt newest shard: chose {Path(cfg.checkpoint.resume_from).name}, "
            f"quarantined {out['quarantined']} ({bad.name} exists {bad.exists()})")
        if Path(cfg.checkpoint.resume_from) != good or bad.exists() or out["quarantined"] != 1:
            raise AssertionError("[faults] the corrupt snapshot was not quarantined on resume")

        # the XL server under a serve.http raise plan
        injected = RESILIENCE_MONITOR.totals()["injected_by_site"].get("serve.http", 0)
        service = PolicyService.from_checkpoint(served_dir, ["serve.batch_ladder=[1]"])
        install({"site": "serve.http", "kind": "raise", "every": 4})
        rng = np.random.default_rng(50)
        with PolicyServer(service, port=0) as server:
            client = PolicyClient(server.url, packed=True, retry_base_s=0.01, timeout=120)
            actions = [client.act({"rgb": rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
                                   "state": rng.standard_normal(4).astype(np.float32)}) for _ in range(16)]
            served = service.stats()["served"]
        faults.clear_plan()
        out["http_injected"] = RESILIENCE_MONITOR.totals()["injected_by_site"].get("serve.http", 0) - injected
        log(f"[faults] XL server, serve.http raise every 4th request: {len(actions)} of 16 actions returned, "
            f"{served} served, {out['http_injected']} faults injected and retried")
        if len(actions) != 16 or served != 16 or out["http_injected"] < 4:
            raise AssertionError("[faults] the served requests were not all answered under the serve.http plan")
        del service
        gc.collect()
        torch.cuda.empty_cache()

        # rollback on the card
        sac = [*(o for o in SAC_STATE if not o.startswith("algo.")), "buffer.checkpoint=False", "algo.run_test=False",
               "algo.learning_starts=8", "algo.total_steps=40", "checkpoint.every=4", "health.poll_every_updates=1",
               "health.min_windows=2", "health.patience=1", "health.divergence.action=rollback"]
        import sheeprl_tpu_torch.algos.sac.sac as sac_module

        targets, rollback_state = [], sac_module.rollback_state
        sac_module.rollback_state = lambda mgr, fabric: targets.append(rollback_state(mgr, fabric)) or targets[-1]
        divergence = json.dumps({"plan": [{"site": "update.grads", "kind": "divergence", "at": 6}]})
        os.environ["SHEEPRL_FAULT_PLAN"] = divergence
        try:
            run([*sac, f"log_dir={run_root / 'rollback'}"])
            rolled = _metric_rows(run_root / "rollback", "Health/rollbacks")
            try:
                run([*sac, "health.divergence.max_rollbacks=0", f"log_dir={run_root / 'budget'}"])
                budget = "no error"
            except DivergenceError as e:
                budget = str(e)
            os.environ["SHEEPRL_FAULT_PLAN"] = json.dumps(
                {"plan": [{"site": "update.grads", "kind": "divergence", "at": 2}]})
            try:
                run([*REPLAY_DV3_SMALL, "health.poll_every_updates=1", "health.min_windows=1", "health.patience=1",
                     "health.divergence.action=rollback", f"log_dir={run_root / 'dv3_divergence'}"])
                dreamer = "no error"
            except DivergenceError as e:
                dreamer = str(e)
        finally:
            del os.environ["SHEEPRL_FAULT_PLAN"]
            sac_module.rollback_state = rollback_state
        out["sac_rollbacks"] = rolled[-1] if rolled else 0.0
        first = targets[0] if targets else (None, None)
        log(f"[faults] SAC on the card, divergence at guarded window 6: Health/rollbacks {out['sac_rollbacks']:.0f}, "
            f"the first to {first[1].name if first[1] else None} (policy step "
            f"{first[0]['policy_step'] if first[0] else None}); with max_rollbacks=0: {budget}; DreamerV3 (XS), "
            f"divergence at window 2: {dreamer}")
        if (out["sac_rollbacks"] < 1 or first[0] is None or "exhausted" not in budget
                or "resume_from=auto" not in dreamer):
            raise AssertionError("[faults] the divergence drills did not roll back or raise as they should")
    finally:
        faults.clear_plan()
    return out


def _metric_rows(log_dir: Path, name: str) -> list:
    import csv

    with open(next(log_dir.glob("**/metrics.csv"))) as f:
        return [float(v) for _, n, v in list(csv.reader(f))[1:] if n == name]


def phase_runtime(torch, run_root: Path, served_dir: Path, preempt: bool = True) -> dict:
    """Phases 48-50 (without ``preempt``, 48 and 50: the whole run has 49
    among the drills of :func:`phase_vecenv`)."""
    t0 = time.perf_counter()
    out = {"dv3_xl": phase_runtime_guard(torch, "runtime-dv3-xl", [*XL_TRAIN, FUSED], "rssm"),
           "dv3_s_gru": phase_runtime_guard(torch, "runtime-dv3-s-gru", S_TRAIN, "gru")}
    if preempt:
        out["preempt"] = phase_runtime_preempt(torch, run_root)
    out["faults"] = phase_runtime_faults(torch, run_root, served_dir)
    out["seconds"] = time.perf_counter() - t0
    log(f"[runtime] phases 48-50 in {out['seconds']:.1f} s")
    return out


def runtime_only(torch) -> int:
    """``--runtime``: phases 48-50 alone (the served snapshot of phase 50
    built as phase 4 builds it)."""
    log_phase_seconds()
    phase_device(torch)
    phase_build()
    run_root = ROOT / "build" / "chip_smoke_runtime"
    shutil.rmtree(run_root, ignore_errors=True)
    try:
        served_dir = run_root / "fused_pallas"
        _build_snapshot(torch, [*XL_SERVE, FUSED], served_dir)
        runtime = phase_runtime(torch, run_root, served_dir)
        log("[runtime] " + json.dumps(runtime_summary(runtime), default=float))
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    return 0


def runtime_summary(r: dict) -> dict:
    return {"seconds": r["seconds"],
            **{f"{k}_updates_per_s": r[k]["updates_per_s"] for k in ("dv3_xl", "dv3_s_gru")},
            **{f"{k}_peak_gib": {n: b / 2**30 for n, b in r[k]["peak_bytes"].items()} for k in ("dv3_xl", "dv3_s_gru")},
            "preempt": {k: v for k, v in r["preempt"].items() if k not in ("first", "saved_dir")},
            "faults": r["faults"]}


# -- the telemetry subsystem and serving's hot reload (phases 51-53) ---------
# phase 7's XL recipe without its test episode, traced at dispatches 1 (the
# first window: chunk 4 run eagerly and captured, then replayed) and 3 (a
# replay of the 1-update chunk), one dispatch per window
# replay ratio 1/16: 4 updates at step 65 (one chunk), then one at steps 81 and 97, so dispatch 3 replays
TELEMETRY_XL = (*XL_TRAIN, "algo.replay_ratio=0.0625", "algo.total_steps=97", FUSED, "algo.run_test=False",
                "telemetry.introspect.port=0")
TRACE_AT = (1, 3)
RSSM_KERNELS_PER_LAUNCH = 4  # csrc/rssm.cu: four launches on the caller's stream per call
SPANS_AB_SAC_CALLS = 50  # SAC updates per timed turn of phase 51's span A/B
RELOAD_POLL_S = 0.5  # phase 53's serve.reload_poll_s
RELOAD_SEED = 9  # the newer snapshot's weights


def _http_get(url: str) -> tuple:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _trace_kernels(path: Path) -> dict:
    """Kernel events of one Chrome trace: all of them and the port's
    (``sheeprl::`` in the name).  The trace of an XL window is hundreds of
    MB: its kernel events are matched in the text, and the JSON is parsed
    only when that finds none."""
    text = path.read_text()
    names = re.findall(r'"cat":\s*"kernel",\s*"name":\s*"([^"]*)"', text)
    if not names:
        names = [e.get("name", "") for e in json.loads(text)["traceEvents"] if e.get("cat") == "kernel"]
    return {"kernels": len(names), "sheeprl": sum("sheeprl::" in n for n in names), "bytes": path.stat().st_size}


def _telemetry_run(torch, overrides, log_dir: Path, traced: bool, snapshot: bool = True) -> dict:
    """One DV3-XL run of ``TELEMETRY_XL`` through ``cli.run`` under cuDNN's
    deterministic algorithms, every launch count zeroed just before and read
    just after.  ``traced``: trace windows at ``TRACE_AT`` (the launches
    credited between each window's start and stop are kept), and
    ``/healthz``, ``/metrics`` and ``/v1/phase`` scraped on another thread
    once two update dispatches have completed.  Without ``snapshot`` the run
    saves none and its trainer's final state is returned (``"state"``, on
    the host)."""
    from sheeprl_tpu_torch import telemetry
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.ops import gru, rssm
    from sheeprl_tpu_torch.telemetry.spans import SPANS
    from sheeprl_tpu_torch.telemetry.tracer import TRACER

    windows, scraped, done = [], {}, threading.Event()
    start, stop = TRACER._start, TRACER._stop

    def counted_start(n):
        windows.append({"update": n, "at_start": rssm.LAUNCHES["rssm"]})
        start(n)

    def counted_stop(n=None):
        stop(n)
        windows[-1]["at_stop"] = rssm.LAUNCHES["rssm"]

    def scrape():
        first = SPANS.updates_done
        while not done.is_set():
            server = telemetry.introspection_server()
            if server is not None and SPANS.updates_done >= first + 2:
                for path in ("/healthz", "/metrics", "/v1/phase"):
                    scraped[path] = _http_get(server.url + path)
                scraped["during_update"] = SPANS.depth()
                return
            time.sleep(0.05)

    extra = [f"telemetry.trace_at=[{','.join(map(str, TRACE_AT))}]", "telemetry.trace_updates=1"] if traced else []
    trainers, init = [], DV3Trainer.__init__

    def kept_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        trainers.append(self)

    if not snapshot:
        extra.append("checkpoint.save_last=False")
        DV3Trainer.__init__ = kept_init
    gc.collect()
    torch.cuda.empty_cache()
    rssm.LAUNCHES["rssm"] = gru.LAUNCHES["gru"] = 0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    TRACER._start, TRACER._stop = counted_start, counted_stop
    scraper = threading.Thread(target=scrape, daemon=True)
    if traced:
        scraper.start()
    t0 = time.perf_counter()
    try:
        run([*overrides, *extra, f"log_dir={log_dir}"])
    finally:
        done.set()
        TRACER._start, TRACER._stop = start, stop
        torch.backends.cudnn.deterministic = deterministic
        DV3Trainer.__init__ = init
    wall = time.perf_counter() - t0
    if traced:
        scraper.join(10)
    counts = {"rssm": rssm.LAUNCHES["rssm"], "gru": gru.LAUNCHES["gru"]}
    out = {"wall_s": wall, "counts": counts, "windows": windows, "scraped": scraped,
           "metrics": next(log_dir.glob("**/metrics.csv")),
           "traces": sorted(log_dir.glob("**/trace/update_*/trace.json"))}
    if snapshot:
        out["snapshot"] = sorted(log_dir.glob("**/checkpoint/step_*"))[-1]
    else:  # an XL snapshot is ≈ 2.6 GB written; the state is compared in memory
        trainer = trainers[-1]
        from sheeprl_tpu_torch.checkpoint.manager import to_host

        out["state"] = to_host({"agent": trainer.agent_state(), "opt_state": trainer.opt_state()})
        del trainer, trainers[:]
    return out


def phase_telemetry_traced(torch, run_root: Path) -> dict:
    """Phase 51 (first half): DV3-XL (``fused_pallas``) through ``cli.run``
    with the default telemetry, ``telemetry.introspect.port=0`` and trace
    windows at dispatches 1 and 3, beside the same run untraced."""
    import csv

    from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir

    traced = _telemetry_run(torch, TELEMETRY_XL, run_root / "traced", traced=True, snapshot=False)
    # the untraced twin registers its sub-models when it ends (phase 54 reads them)
    untraced = _telemetry_run(torch, (*TELEMETRY_XL, *registry_overrides(run_root / "registry_run")),
                              run_root / "untraced", traced=False)
    untraced["registry_root"] = run_root / "registry_run"
    a, b = traced.pop("state"), load_step_dir(untraced["snapshot"], map_location="cpu")
    pairs = [(x, y) for name in ("agent", "opt_state") for x, y in zip(_tensor_leaves(a[name]), _tensor_leaves(b[name]))]
    equal = sum(torch.equal(x, y) for x, y in pairs)

    def losses(r):
        with open(r["metrics"]) as f:
            return {(step, n): v for step, n, v in list(csv.reader(f))[1:] if n in LOSS_NAMES}

    la, lb = losses(traced), losses(untraced)
    same_losses = la == lb and len(la) >= len(LOSS_NAMES)
    with open(traced["metrics"]) as f:
        names = {n for _, n, _ in list(csv.reader(f))[1:]}
    kernels = [_trace_kernels(p) for p in traced["traces"]]
    credited = [w.get("at_stop", 0) - w["at_start"] for w in traced["windows"]]
    scraped = traced["scraped"]
    health = json.loads(scraped["/healthz"][1]) if "/healthz" in scraped else {}
    metrics_text = scraped.get("/metrics", (0, ""))[1]
    phase = json.loads(scraped["/v1/phase"][1]) if "/v1/phase" in scraped else {}
    log(f"[telemetry] DV3-XL through cli.run, traced at dispatches {list(TRACE_AT)} ({traced['wall_s']:.1f} s) and "
        f"untraced ({untraced['wall_s']:.1f} s), cuDNN deterministic: {equal} of {len(pairs)} trained tensors and "
        f"the ten losses {'equal' if same_losses else 'NOT equal'} bit for bit; trace windows at updates "
        f"{[w['update'] for w in traced['windows']]}: sheeprl:: kernels in the traces "
        f"{[k['sheeprl'] for k in kernels]} of {[k['kernels'] for k in kernels]} kernels "
        f"({[round(k['bytes'] / 2**20, 1) for k in kernels]} MiB), rssm launches credited in the windows "
        f"{credited} x {RSSM_KERNELS_PER_LAUNCH} kernels each; run launches traced {traced['counts']}, untraced {untraced['counts']}")
    log(f"[telemetry] scraped mid-run: /healthz {scraped.get('/healthz', (None,))[0]} (updates_done "
        f"{health.get('updates_done')}, sources {health.get('sources')}), /metrics "
        f"{scraped.get('/metrics', (None,))[0]} ({metrics_text.count(chr(10)) // 2} metrics), /v1/phase "
        f"{scraped.get('/v1/phase', (None,))[0]} (phases {sorted(phase.get('phases', {}))}); Phase/* logged "
        f"{sorted(n for n in names if n.startswith('Phase/'))}")
    ok = (equal == len(pairs) and same_losses and len(kernels) == len(TRACE_AT)
          and [k["sheeprl"] for k in kernels] == [RSSM_KERNELS_PER_LAUNCH * c for c in credited]
          and all(c > 0 for c in credited)
          and traced["counts"] == untraced["counts"]
          and scraped.get("/healthz", (0,))[0] == 200 and health.get("ok") is True
          and scraped.get("/metrics", (0,))[0] == 200 and "sheeprl_compile_executables" in metrics_text
          and scraped.get("/v1/phase", (0,))[0] == 200 and {"Phase/rollout", "Phase/update.dispatch"} <= names)
    if not ok:
        raise AssertionError("[telemetry] the traced run differs from the untraced one, a trace misses the kernel's "
                             "launches, or the endpoints did not answer")
    return {"traced": traced, "untraced": untraced, "trace_kernels": kernels, "credited": credited,
            "bit_for_bit": equal, "tensors": len(pairs)}


def _tensor_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensor_leaves(x)]
    return [tree] if hasattr(tree, "dtype") and hasattr(tree, "shape") else []


def phase_telemetry_spans(torch, sac_run: dict, xl: dict) -> dict:
    """Phase 51 (second half), on phase 38's kept XL window ``xl``: a fenced
    span (``telemetry.spans.sync``) around its replayed chunk inside
    ``steady_guard`` must not trip the guard; then spans on and off in turns
    (on, off, off, on) around that captured chunk and around SAC's eager
    update (``sac_run``: a SAC run's ``trainer`` and last ``batches``), each
    call inside ``timer("Time/train_time")`` as the loops make it (the
    ``update.dispatch`` span, no trace window: no fence)."""
    from sheeprl_tpu_torch.telemetry.spans import SPANS
    from sheeprl_tpu_torch.utils.timer import timer

    f, counter0 = xl["graph"], xl["counter0"]
    sac_trainer, batches = sac_run["trainer"], sac_run["batches"]
    one = {k: v[:1] for k, v in batches.items()}
    sac_gen = torch.Generator(one["rewards"].device)

    def spanned(fn, on: bool, calls: int = 1):
        def turn():
            SPANS.enabled = on
            for _ in range(calls):
                with timer("Time/train_time"):
                    fn()
        return turn

    # a fenced span edge (spans.sync) inside steady_guard: the fence is an
    # explicit synchronise, which the guard's sync debug mode lets through
    from sheeprl_tpu_torch.data.device_replay import steady_guard
    from sheeprl_tpu_torch.telemetry.spans import span

    SPANS.sync = True
    try:
        with steady_guard(True), span("replay.write"):
            f(GRAPH_CHUNK, counter0)
    finally:
        SPANS.sync = False
    log("[telemetry-spans] a fenced span around a replayed XL chunk inside steady_guard: no error")

    chunk = lambda: f(GRAPH_CHUNK, counter0)  # noqa: E731
    sac = lambda: sac_trainer.train_phase(one, sac_gen.manual_seed(0), 0)  # noqa: E731
    order = ("spans", "no spans", "no spans", "spans")
    try:
        xl_turns = _turns(torch, {"spans": spanned(chunk, True), "no spans": spanned(chunk, False)}, order=order)
        sac_turns = _turns(torch, {"spans": spanned(sac, True, SPANS_AB_SAC_CALLS),
                                   "no spans": spanned(sac, False, SPANS_AB_SAC_CALLS)}, order=order)
    finally:
        SPANS.enabled = True
        timer.to_dict(reset=True)
    out = {"dv3_xl": {k: [GRAPH_CHUNK / t for t in v["s"]] for k, v in xl_turns.items()},
           "sac": {k: [SPANS_AB_SAC_CALLS / t for t in v["s"]] for k, v in sac_turns.items()}}
    for name, rates in out.items():
        log(f"[telemetry-spans] {name}: updates/s in turns spans {rates['spans'][0]:.3f}, no spans "
            f"{rates['no spans'][0]:.3f}, no spans {rates['no spans'][1]:.3f}, spans {rates['spans'][1]:.3f}")
    return out


def phase_telemetry_signals(torch, preempt: dict) -> dict:
    """Phase 52, in subprocesses: phase 49's preempted DV3-XL child took a
    SIGUSR1 after its first replayed window (one trace window of the live
    run) before its SIGTERM, whose committed save comes before the
    ``preemption`` postmortem; a planted raise (``checkpoint.write_shard``)
    in a small DreamerV3 run, started beside that child, dumps
    ``postmortem.json`` with its ``crash`` event and lands the final flush."""
    import csv

    first, saved_dir = preempt["first"], preempt["saved_dir"]
    run_dir = saved_dir.parents[1]
    traces = sorted(run_dir.glob("trace/update_*/trace.json"))
    kernels = [_trace_kernels(p) for p in traces]
    with open(run_dir / "postmortem.json") as f:
        doc = json.load(f)
    kinds = [e["kind"] for e in doc["events"]]
    dumped_after = (run_dir / "postmortem.json").stat().st_mtime - (saved_dir / "COMMIT").stat().st_mtime
    saves = [e["seconds"] for e in doc["events"] if e["kind"] == "ckpt.save"]
    log(f"[telemetry-signals] SIGUSR1: {len(traces)} trace window ({[t.parent.name for t in traces]}, sheeprl:: "
        f"kernels {[k['sheeprl'] for k in kernels]}); SIGTERM: committed {first['signal_to_commit_s']:.2f} s after "
        f"the signal (phase 49's run; the save itself {saves[-1] if saves else None} s), postmortem "
        f"'{doc['reason']}' {dumped_after:.3f} s after the commit, events {sorted(set(kinds))}")
    if not (len(traces) == 1 and kernels[0]["sheeprl"] > 0 and doc["reason"] == "preemption"
            and {"trace.start", "trace.stop", "ckpt.save", "preemption"} <= set(kinds) and dumped_after >= 0):
        raise AssertionError("[telemetry-signals] the live run's trace window or its preemption postmortem is wrong")

    # the planted raise, started beside phase 49's child
    proc, log_dir, output = first["crash"]
    try:
        proc.wait(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    (pm,) = log_dir.glob("**/postmortem.json")
    with open(pm) as f:
        crash = json.load(f)
    crash_kinds = [e["kind"] for e in crash["events"]]
    with open(next(log_dir.glob("**/metrics.csv"))) as f:
        rows = list(csv.reader(f))[1:]
    last = max(int(s) for s, _, _ in rows)
    landed = any(n == "Resilience/faults_injected" and int(s) == last for s, n, _ in rows)
    log(f"[telemetry-signals] planted raise: exit {proc.returncode}, postmortem '{crash['reason']}', crash event "
        f"{[e.get('error') for e in crash['events'] if e['kind'] == 'crash']}, final flush landed "
        f"Resilience/faults_injected at step {last}: {landed}")
    if not (proc.returncode != 0 and crash["reason"] == "exception" and "crash" in crash_kinds and landed):
        raise AssertionError(f"[telemetry-signals] the planted raise left no postmortem:\n"
                             f"{output.read_text()[-6000:]}")
    return {"signal_to_commit_s": first["signal_to_commit_s"], "postmortem_after_commit_s": dumped_after,
            "save_s": saves[-1] if saves else None,
            "usr1_trace_kernels": kernels[0], "crash_rc": proc.returncode}


def _stage_snapshot(torch, overrides, staging: Path, step: int, corrupt: bool = False) -> Path:
    """A committed snapshot of an agent initialised on the card from the
    config's seed, written under ``staging`` (to be moved into a watched
    root at once); with ``corrupt``, a small one whose shard is damaged after
    its CRC was taken (a ``checkpoint.write_shard corrupt`` plan)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.checkpoint.protocol import write_snapshot
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.resilience import faults
    from sheeprl_tpu_torch.serve.loader import probe_spaces

    if corrupt:  # the watcher's CRC check refuses it before any load
        faults.install_plan(faults.FaultPlan.from_specs([{"site": "checkpoint.write_shard", "kind": "corrupt",
                                                          "at": 1}]))
        try:
            return write_snapshot(staging, step, {"agent": {"w": torch.arange(4096.0)}})
        finally:
            faults.clear_plan()
    cfg = compose(list(overrides))
    fabric = build_fabric(cfg)
    obs_space, action_space = probe_spaces(cfg)
    dims, cont = spaces_to_dims(action_space)
    modules = build_agent(fabric, dims, cont, cfg, obs_space)
    step_dir = write_snapshot(staging, step, {"agent": {n: m.state_dict() for n, m in modules.items()}})
    del modules
    torch.cuda.empty_cache()
    return step_dir


def phase_telemetry_reload(torch, run_root: Path, served_dir: Path) -> dict:
    """Phase 53: the XL server (``fused_pallas``, every rung a captured
    graph) under 16 sessions while a newer committed snapshot (other
    weights) lands in its watched root: every request answered, the
    watcher's load starts within ``serve.reload_poll_s`` of the commit, the
    install copies into the captured step's tensors (no capture: the compile
    monitor's totals unchanged), and the served action and carry for a fixed
    observation and seed equal a fresh service's on the new snapshot bit for
    bit; then a corrupt snapshot is quarantined while serving goes on."""
    from sheeprl_tpu_torch.ops import gru, rssm
    from sheeprl_tpu_torch.serve.client import PolicyClient
    from sheeprl_tpu_torch.serve.server import PolicyServer
    from sheeprl_tpu_torch.serve.service import PolicyService
    from sheeprl_tpu_torch.telemetry.monitors import COMPILE_MONITOR

    from sheeprl_tpu_torch.checkpoint import protocol

    root = served_dir / "checkpoint"
    staging = run_root / "reload_staging"
    newer = _stage_snapshot(torch, [*XL_SERVE, FUSED, f"seed={RELOAD_SEED}"], staging, 2)
    bad = _stage_snapshot(torch, None, staging, 3, corrupt=True)
    service = PolicyService.from_checkpoint(served_dir, [f"serve.reload_poll_s={RELOAD_POLL_S}"])
    watcher = service.watcher
    found, loads, installs = [], [], []
    load_params, newer_checkpoint = watcher._load_params, protocol.newer_checkpoint

    def seen_newer(ckpt_root, after_step):
        out = newer_checkpoint(ckpt_root, after_step)
        if out is not None:
            found.append((time.time(), out.name))
        return out

    def timed_load(step_dir):
        t0 = time.time()
        try:
            return load_params(step_dir)
        finally:
            loads.append((t0, time.time(), step_dir.name))

    watcher._load_params = timed_load
    watcher._on_reload = lambda gen, step: installs.append((time.time(), gen, step))
    server = PolicyServer(service, port=0).start()
    mark = COMPILE_MONITOR.totals()
    player = service.player
    valid = _action_check(service)
    stop, errors, answered = threading.Event(), [], [0]
    lock = threading.Lock()

    def session(i: int) -> None:
        client = PolicyClient(server.url, packed=True, timeout=120)
        rng = np.random.default_rng(i)
        try:
            while not stop.is_set():
                obs = {k: rng.integers(0, 256, shape, dtype=np.uint8) if dtype == "uint8"
                       else rng.standard_normal(shape).astype(np.float32) for k, (shape, dtype) in
                       player.obs_spec.items()}
                action = client.act(obs, session=f"s{i}", greedy=i % 2 == 0)
                if not valid(action):
                    raise AssertionError(f"invalid action {action!r}")
                with lock:
                    answered[0] += 1
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    rssm.LAUNCHES["rssm"] = gru.LAUNCHES["gru"] = 0
    threads = [threading.Thread(target=session, args=(i,), daemon=True) for i in range(SERVE_SESSIONS)]
    protocol.newer_checkpoint = seen_newer
    try:
        try:
            for t in threads:
                t.start()
            time.sleep(2.0)
            t_land = time.time()
            os.replace(newer, root / newer.name)  # the commit lands in the watched root at once
            deadline = time.monotonic() + 120
            while service.store.step != 2 and time.monotonic() < deadline and not errors:
                time.sleep(0.02)
            time.sleep(1.0)
        finally:
            stop.set()
            for t in threads:
                t.join(120)
        counts = {"rssm": rssm.LAUNCHES["rssm"], "gru": gru.LAUNCHES["gru"]}
        stats = service.stats()
        if errors:
            raise errors[0]
        detect = found[0][0] - t_land if found else None
        swap = installs[0][0] - t_land if installs else None
        log(f"[reload] XL server, {SERVE_SESSIONS} sessions while step 2 (seed {RELOAD_SEED}) landed: {answered[0]} "
            f"requests answered, {stats['errors']} errors, {stats['served']} served in {stats['batches']} batches; the "
            f"watcher found it {detect:.3f} s after the commit (poll {RELOAD_POLL_S} s), read + stage "
            f"{loads[0][1] - loads[0][0]:.3f} s, installed {swap:.3f} s after the commit with a "
            f"{stats['reload_pause_ms']:.3f} ms pause; generation {stats['generation']}, step {stats['checkpoint_step']}; "
            f"compile totals {mark} -> {COMPILE_MONITOR.totals()}; launches {counts}")
        if not (answered[0] == stats["served"] and stats["errors"] == 0 and installs and installs[0][1:] == (1, 2)
                and detect is not None and detect <= RELOAD_POLL_S + 0.5 and COMPILE_MONITOR.totals() == mark
                and counts["rssm"] >= stats["batches"]):
            raise AssertionError("[reload] a request failed, the reload was late or recaptured")

        rng = np.random.default_rng(53)
        raw = {"rgb": rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8),
               "state": rng.standard_normal((1, 4)).astype(np.float32)}

        def fixed_step(svc):
            obs = svc.player.prepare(raw)
            with svc.store.serving() as (params, _, _):
                return svc.player.step_batch(params, svc.player.zero_carry(1), obs, 1234, np.zeros((1,), bool))

        reloaded = fixed_step(service)

        # a corrupt snapshot lands: quarantined after reload_failure_threshold loads, serving goes on
        os.replace(bad, root / bad.name)
        client = PolicyClient(server.url, packed=True, timeout=120)
        served_meanwhile = 0
        deadline = time.monotonic() + 120
        while watcher.quarantined < 1 and time.monotonic() < deadline:
            client.act({k: np.zeros(shape, np.dtype(dtype)) for k, (shape, dtype) in player.obs_spec.items()})
            served_meanwhile += 1
        health = client.health()
        log(f"[reload] corrupt step 3: quarantined {watcher.quarantined} ({(root / bad.name).exists()} left in the root), "
            f"{served_meanwhile} requests served meanwhile, step {service.store.step}, /healthz degraded "
            f"{health['degraded']} ({health['reload_breaker']['state']}); {watcher.last_error}")
    finally:
        protocol.newer_checkpoint = newer_checkpoint
    if not (watcher.quarantined == 1 and not (root / bad.name).exists() and service.store.step == 2
            and health["degraded"] and served_meanwhile > 0):
        raise AssertionError("[reload] the corrupt snapshot was not quarantined while the old parameters served")
    server.stop()
    del service, server, client
    gc.collect()
    torch.cuda.empty_cache()

    fresh = PolicyService.from_checkpoint(root / "step_000000000002", ["serve.watch_commits=False"]).start()
    try:
        expected = fixed_step(fresh)
    finally:
        fresh.stop()
    same = all(np.array_equal(a, b) for a, b in zip(reloaded[0], expected[0])) and np.array_equal(reloaded[1],
                                                                                                    expected[1])
    log(f"[reload] the reloaded server's step for a fixed observation and seed against a fresh service on step 2: "
        f"carry and action {'equal' if same else 'NOT equal'} bit for bit")
    if not same:
        raise AssertionError("[reload] the reloaded parameters do not serve as the new snapshot does")
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    return {"answered": answered[0], "counts": counts, "detect_s": detect, "swap_s": swap,
            "load_s": loads[0][1] - loads[0][0], "pause_ms": stats["reload_pause_ms"], "batches": stats["batches"]}


def phase_telemetry(torch, run_root: Path, served_dir: Path, spans: dict, preempt: dict = None) -> dict:
    """Phases 51-53, beside the span turns ``spans`` phase_graphs ran on
    phase 38's window (without ``preempt``, phase 52's signal checks on
    phase 49's child are left to the caller)."""
    t0 = time.perf_counter()
    out = {"traced": phase_telemetry_traced(torch, run_root / "telemetry"), "spans": spans}
    if preempt is not None:
        out["signals"] = phase_telemetry_signals(torch, preempt)
    out["reload"] = phase_telemetry_reload(torch, run_root / "telemetry", served_dir)
    out["seconds"] = time.perf_counter() - t0
    log(f"[telemetry] phases 51-53 in {out['seconds']:.1f} s")
    return out


def telemetry_summary(t: dict) -> dict:
    return {"seconds": t["seconds"], "trace_kernels": t["traced"]["trace_kernels"], "credited": t["traced"]["credited"],
            "bit_for_bit": [t["traced"]["bit_for_bit"], t["traced"]["tensors"]],
            "traced_wall_s": t["traced"]["traced"]["wall_s"], "untraced_wall_s": t["traced"]["untraced"]["wall_s"],
            "spans_updates_per_s": t["spans"], "signals": t["signals"], "reload": t["reload"]}


# -- the deployment surface: registry, a JAX-written snapshot, the fleet (phases 54-56)
FIXTURE_DIR = ROOT / "tests" / "fixtures" / "jax_dv3"  # tools/write_jax_fixture.py
DV3_REGISTERED = ("world_model", "actor", "critic", "target_critic", "moments")
FLEET_REPLICAS = 2
FLEET_KILL_STEPS = 24  # steps per session of phase 56's kill drill (the kill lands after a third)
FLEET_ROLL_SEED = 11  # the weights of the snapshot phase 56 rolls out
DEPLOY_DEVICE = "fabric.accelerator=gpu"
FLEET_OVERRIDES = (DEPLOY_DEVICE, f"serve.fleet.replicas={FLEET_REPLICAS}", "serve.fleet.port=0",
                   "serve.fleet.reload_poll_s=0.5", "serve.fleet.health_poll_s=0.25", "serve.fleet.readmit_s=1.0",
                   "serve.fleet.respawn_backoff_base_s=0.2", "serve.fleet.respawn_backoff_max_s=0.5")


def registry_overrides(root: Path) -> tuple:
    """A run that registers its sub-models under ``root`` when it ends."""
    return ("model_manager.disabled=False", f"model_manager.registry_root={root}")


def _registered(torch, root: Path, snapshot: Path) -> dict:
    """Each DreamerV3 sub-model registered under ``root``, against the
    snapshot's tensors, bit for bit."""
    from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
    from sheeprl_tpu_torch.serve.loader import load_run_config
    from sheeprl_tpu_torch.utils.model_manager import FileSystemModelManager

    cfg = load_run_config(snapshot)
    mm = FileSystemModelManager(root)
    agent = load_step_dir(snapshot, map_location="cpu")["agent"]
    out = {}
    for key in DV3_REGISTERED:
        name = cfg.model_manager.models[key].model_name
        got, want = mm.load_model(name), agent[key]
        out[key] = {"name": name, "version": mm.get_model_info(name)["version"], "tensors": len(want),
                    "equal": set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want),
                    "bytes": Path(mm.download_model(name)).stat().st_size}
    return out


def phase_registry(torch, snapshot: Path, run_root: Path, run_twin: dict) -> dict:
    """Phase 54: ``cli.registration`` of the trained DreamerV3-XL snapshot
    (phase 7's): its five sub-models registered at v1, each loaded back equal
    to the snapshot's tensors bit for bit; phase 51's untraced ``cli.run``
    twin, run with ``model_manager.disabled=False``, registered the same
    five at v1 from its own snapshot; ``available_agents`` lists every
    algorithm the port registers."""
    import io

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.utils.registry import algorithm_registry

    root = run_root / "registry"
    t0 = time.perf_counter()
    versions = cli.registration([f"checkpoint_path={snapshot}", f"model_manager.registry_root={root}"])
    seconds = time.perf_counter() - t0
    registered = _registered(torch, root, snapshot)
    twin = _registered(torch, run_twin["registry_root"], run_twin["snapshot"])
    shown = io.StringIO()
    with contextlib.redirect_stdout(shown):
        cli.available_agents()
    missing = sorted(n for n in algorithm_registry if n not in shown.getvalue())
    log(f"[registry] cli.registration of {snapshot.name}: {versions} in {seconds:.1f} s; loaded back bit for bit: "
        + ", ".join(f"{r['name']} v{r['version']} {r['tensors']} tensors {r['bytes'] / 2**20:.1f} MiB "
                    f"{'equal' if r['equal'] else 'NOT equal'}" for r in registered.values()))
    log(f"[registry] cli.run with model_manager.disabled=False registered "
        + ", ".join(f"{r['name']} v{r['version']} {'equal' if r['equal'] else 'NOT equal'}" for r in twin.values())
        + f"; available_agents lists {len(algorithm_registry) - len(missing)} of {len(algorithm_registry)} algorithms")
    ok = (versions == {k: 1 for k in DV3_REGISTERED} and not missing
          and all(r["equal"] and r["version"] == 1 for r in (*registered.values(), *twin.values())))
    if not ok:
        raise AssertionError(f"[registry] the registered models are not the snapshot's (missing agents {missing})")
    return {"seconds": seconds, "registered": registered, "twin": twin, "agents": len(algorithm_registry)}


class _ServeChild:
    """A serving entry point of the port (``python -m <module> <args>``)
    started in the background, its output collected, so that its start
    overlaps other work."""

    def __init__(self, args, tag: str):
        self.tag, self.t0 = tag, time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.lines, self._seen = [], threading.Event()
        _read_lines(self.proc, self.lines, self._seen, self._is_url)

    @staticmethod
    def _is_url(line: str) -> bool:  # its own line, not a fleet replica's ([r0] ...)
        return bool(re.search(r" on http://[\d.]+:\d+", line)) and not line.startswith("[r")

    def url(self, timeout: float = 600.0) -> str:
        """Its URL once it has bound; ``ready_s``: seconds from its start."""
        if not self._seen.wait(timeout):
            self.proc.kill()
            raise AssertionError(f"[{self.tag}] printed no URL:\n{''.join(self.lines)[-4000:]}")
        self.ready_s = time.perf_counter() - self.t0
        return re.search(r" on (http://[\d.]+:\d+)", next(l for l in self.lines if self._is_url(l))).group(1)


def _stop_child(proc, sig=signal.SIGINT, timeout: float = 60.0) -> int:
    if proc.poll() is None:
        proc.send_signal(sig)
        try:
            proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return proc.returncode


def _carry_snapshot(rows, session: str) -> dict:
    """A ``/v1/session_carry`` snapshot of one session's carry rows."""
    from sheeprl_tpu_torch.serve.server import encode_array
    from sheeprl_tpu_torch.serve.service import _carry_crc

    leaves = [np.ascontiguousarray(r, np.float32).reshape(1, -1) for r in rows]
    return {"session": session, "algo": "dreamer_v3", "carry": [encode_array(x, packed=True) for x in leaves],
            "crc": _carry_crc(leaves)}


def _carry_rows(snapshot: dict) -> list:
    from sheeprl_tpu_torch.serve.server import decode_array

    return [decode_array(x) for x in snapshot["carry"]]


def jax_serve_child(run_root: Path) -> _ServeChild:
    """Phase 55's server: the fixture copied under ``run_root`` and served
    on the card by ``python -m sheeprl_tpu_torch.serve``."""
    run_dir = run_root / "jax_dv3"
    shutil.copytree(FIXTURE_DIR, run_dir)
    return _ServeChild(["sheeprl_tpu_torch.serve", f"checkpoint_path={run_dir}", DEPLOY_DEVICE, "serve.port=0",
                        "serve.watch_commits=false"], "jax-serve")


def fleet_child(served_dir: Path) -> _ServeChild:
    """Phase 56's fleet: ``python -m sheeprl_tpu_torch.serve.fleet`` over ``served_dir``."""
    return _ServeChild(["sheeprl_tpu_torch.serve.fleet", f"checkpoint_path={served_dir}", *FLEET_OVERRIDES], "fleet")


def phase_jax_snapshot(torch, run_root: Path, child: _ServeChild = None) -> dict:
    """Phase 55: the DreamerV3 snapshot the JAX package wrote
    (``tests/fixtures/jax_dv3``, ``fused_pallas=True``), served on the card
    through ``cli.serve`` (``python -m sheeprl_tpu_torch.serve``): its
    ``/v1/stats`` counts at least one rssm launch per batch and no gru launch;
    each recorded input row, restored as a session carry and stepped alone,
    gives JAX's h' within 1e-4; and the player ``load_policy`` builds from
    it on the card gives JAX's h', posterior logits and actor logits within
    1e-4 on the recorded batch (the sampled latent and greedy action equal)."""
    from sheeprl_tpu_torch.ops import gru, rssm
    from sheeprl_tpu_torch.serve.client import PolicyClient
    from sheeprl_tpu_torch.serve.loader import load_policy

    child = child or jax_serve_child(run_root)
    run_dir = run_root / "jax_dv3"
    x = dict(np.load(run_dir / "outputs.npz"))
    proc = child.proc
    try:
        url = child.url()
        client = PolicyClient(url, packed=True, timeout=120)
        health = client.health()
        valid = lambda a: a.shape == tuple(health["action_shape"]) and 0 <= int(a) < 4  # noqa: E731
        spec = {k: (tuple(s), d) for k, (s, d) in health["obs_spec"].items()}
        player_like = type("Spec", (), {"obs_spec": spec, "algo": health["algo"]})
        wall, latencies = _client_sessions(url, player_like, valid, 4, 4)
        served_h = []
        for i in range(len(x["h"])):  # each recorded row alone: rung 1
            client.restore_session_carry(f"jax-{i}", _carry_snapshot((x["h"][i], x["z"][i], x["a"][i]), f"jax-{i}"))
            client.act({"rgb": x["rgb"][i], "state": x["state"][i]}, session=f"jax-{i}", greedy=True)
            served_h.append(_carry_rows(client.session_carry(f"jax-{i}"))[0][0])
        stats = client.stats()
    finally:
        rc = _stop_child(proc)
    served_err = float(np.abs(np.stack(served_h) - x["h_next"]).max())
    launches = stats["kernel_launches"]

    rssm.LAUNCHES["rssm"] = gru.LAUNCHES["gru"] = 0
    _, _, _, player = load_policy(run_dir, [DEPLOY_DEVICE])
    wm, actor = player.params["world_model"], player.params["actor"]
    dev = player.device
    t = {k: torch.from_numpy(x[k]).to(dev) for k in ("h", "z", "a", "noise")}
    B = t["h"].shape[0]
    obs = {k: torch.from_numpy(v).to(dev) for k, v in player.prepare({"rgb": x["rgb"], "state": x["state"]}).items()}
    with torch.no_grad():
        h, z, post, _ = wm.dynamic_noise(t["h"], t["z"], t["a"], wm.encode(obs), torch.zeros(B, 1, device=dev),
                                         t["noise"])
        logits = actor(torch.cat([z, h], -1))
        greedy = actor.sample(logits, torch.Generator(dev).manual_seed(0), greedy=True)
    torch.cuda.synchronize()
    in_process = {"rssm": rssm.LAUNCHES["rssm"], "gru": gru.LAUNCHES["gru"]}
    errs = {name: float(np.abs(v.cpu().numpy() - x[key]).max())
            for name, v, key in (("h", h, "h_next"), ("post_logits", post, "post_logits"),
                                 ("actor_logits", logits, "actor_logits"))}
    shape = (B, *x["noise"].shape[1:])
    same_z = bool(np.array_equal(z.cpu().numpy().reshape(shape).argmax(-1), x["z_next"].reshape(shape).argmax(-1)))
    same_a = bool(np.array_equal(greedy.cpu().numpy(), x["greedy_action"]))
    lat = np.asarray(latencies) * 1e3
    log(f"[jax-snapshot] the JAX-written fixture served by cli.serve on the card (exit {rc}): {stats['served']} "
        f"actions in {stats['batches']} batches, launches {launches} (rssm per batch "
        f"{launches['rssm'] / max(1, stats['batches']):.2f}), client p50 {np.percentile(lat, 50):.1f} ms; each "
        f"recorded row stepped alone: h' max abs err {served_err:.2e} against JAX; load_policy's player at B={B}: "
        f"max abs err {', '.join(f'{k} {v:.2e}' for k, v in errs.items())}, latent "
        f"{'equal' if same_z else 'NOT equal'}, greedy action {'equal' if same_a else 'NOT equal'}, launches "
        f"{in_process}")
    ok = (launches["rssm"] >= stats["batches"] > 0 and launches["gru"] == 0 and stats["errors"] == 0
          and served_err <= TOL and all(e <= TOL for e in errs.values()) and same_z and same_a
          and in_process["rssm"] >= 1 and in_process["gru"] == 0)
    if not ok:
        raise AssertionError("[jax-snapshot] the JAX-written snapshot does not serve as JAX computes it on the card")
    del player, wm, actor
    gc.collect()
    torch.cuda.empty_cache()
    return {"served": stats["served"], "batches": stats["batches"], "launches": launches, "in_process": in_process,
            "served_h_err": served_err, "errs": errs}


def _replica_pid(port: int, parent: int) -> int:
    """The pid of ``parent``'s child process listening on ``port``: the
    socket's inode from ``/proc/net/tcp``, matched among the children's
    file descriptors."""
    inodes = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        with contextlib.suppress(FileNotFoundError), open(table) as f:
            for row in list(f)[1:]:
                cols = row.split()
                if int(cols[1].rsplit(":", 1)[1], 16) == port and cols[3] == "0A":  # LISTEN
                    inodes.add(f"socket:[{cols[9]}]")
    for pid in (int(p) for p in os.listdir("/proc") if p.isdigit()):
        try:
            with open(f"/proc/{pid}/stat") as f:
                if int(f.read().rsplit(")", 1)[1].split()[1]) != parent:
                    continue
            if any(os.readlink(f"/proc/{pid}/fd/{fd}") in inodes for fd in os.listdir(f"/proc/{pid}/fd")):
                return pid
        except (FileNotFoundError, ProcessLookupError, PermissionError):
            continue
    raise AssertionError(f"no child of {parent} listens on port {port}")


def _fleet_replicas(router_url: str) -> dict:
    from sheeprl_tpu_torch.serve.client import PolicyClient

    return PolicyClient(router_url, timeout=60).stats()["per_replica"]


def _wait_fleet(router_url: str, healthy: int, timeout: float = 600.0) -> float:
    from sheeprl_tpu_torch.serve.client import PolicyClient

    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        with contextlib.suppress(Exception):
            if PolicyClient(router_url, timeout=10, retries=1).health().get("healthy", 0) >= healthy:
                return time.monotonic() - t0
        time.sleep(0.1)
    raise AssertionError(f"[fleet] {healthy} healthy replicas not reached within {timeout} s")


def _replica_step(torch, url: str, session: str, rows, raw: dict, seed0: int) -> tuple:
    """One step of ``session`` on the replica at ``url`` from carry ``rows``
    and observation ``raw``, alone (rung 1), greedy: the carry after it, the
    action and the dispatch seed (the replica's seed counter: ``seed0`` plus
    its batches, every one of them served)."""
    from sheeprl_tpu_torch.serve.client import PolicyClient

    client = PolicyClient(url, packed=True, timeout=120, retries=1)
    client.restore_session_carry(session, _carry_snapshot(rows, session))
    before = client.stats()
    action = client.act(raw, session=session, greedy=True)
    after = client.stats()
    if before["errors"] or after["batches"] != before["batches"] + 1:
        raise AssertionError(f"[fleet] the probe step on {url} was not one batch of its own: {before} -> {after}")
    return _carry_rows(client.session_carry(session)), action, seed0 + before["batches"] + 1


def _local_step(service, rows, raw: dict, seed: int) -> tuple:
    """The same step on an in-process service's player: its rung-1 graph,
    the dispatch seed given."""
    player = service.player
    carry = tuple(np.asarray(r, np.float32).reshape(1, -1) for r in rows)
    obs = player.prepare({k: np.asarray(v)[None] for k, v in raw.items()})
    with service.store.serving() as (params, _, _):
        new_carry, actions = player.step_batch(params, carry, obs, seed, np.ones((1,), bool))
    return list(new_carry), player.postprocess(actions[:1])[0]


def _same_step(a: tuple, b: tuple) -> bool:
    (carry_a, act_a), (carry_b, act_b) = a, b
    return all(np.array_equal(x, y) for x, y in zip(carry_a, carry_b)) and np.array_equal(act_a, act_b)


def phase_fleet(torch, run_root: Path, served_dir: Path, child: _ServeChild = None) -> dict:
    """Phase 56: ``cli.serve_fleet`` (``python -m sheeprl_tpu_torch.serve.fleet``)
    with two DreamerV3-XL replicas on the card over phase 4's run directory:
    16 sessions through the router and through one in-process server on the
    same snapshot in turns (fleet, single, single, fleet); every replica's
    rssm launches at least one per batch and no gru; a replica SIGKILLed
    under 16 sessions (no request dropped, every session complete, its
    sessions migrated, the slot respawned); a session idle through the kill
    then stepped alone on its slot's new process equal bit for bit to the
    same step from its migrated carry at the same seed in this process; and a
    new committed snapshot rolled out replica by replica under 16 sessions
    (none failed, no replica recaptured, each replica's step equal to a
    fresh service's on the new snapshot bit for bit)."""
    from sheeprl_tpu_torch.checkpoint.protocol import checkpoint_step, latest_checkpoint
    from sheeprl_tpu_torch.serve.client import PolicyClient
    from sheeprl_tpu_torch.serve.fleet import assign_replica
    from sheeprl_tpu_torch.serve.server import PolicyServer
    from sheeprl_tpu_torch.serve.service import PolicyService

    child = child or fleet_child(served_dir)
    proc = child.proc
    replica_pids = {}
    try:
        single = PolicyService.from_checkpoint(served_dir, ["serve.watch_commits=False"])  # while the fleet starts
        server = PolicyServer(single, port=0).start()
        router_url = child.url()
        _wait_fleet(router_url, FLEET_REPLICAS)
        startup_s = time.perf_counter() - child.t0
        seed0 = int(single.cfg.seed)
        valid = _action_check(single)
        replicas = _fleet_replicas(router_url)
        replica_pids = {rid: _replica_pid(int(r["url"].rsplit(":", 1)[1]), proc.pid) for rid, r in replicas.items()}
        log(f"[fleet] router {router_url} over {sorted(replicas)} (pids {replica_pids}) up in {startup_s:.1f} s")

        # -- throughput in turns ----------------------------------------------------------------
        turns = []
        for where, url in (("fleet", router_url), ("single", server.url), ("single", server.url),
                           ("fleet", router_url)):
            wall, latencies = _client_sessions(url, single.player, valid, SERVE_SESSIONS, SERVE_STEPS)
            lat = np.asarray(latencies) * 1e3
            turns.append({"where": where, "actions_per_s": len(latencies) / wall,
                          "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99))})
            log(f"[fleet] turn {len(turns)} {where}: {SERVE_SESSIONS} sessions x {SERVE_STEPS} steps, "
                f"{turns[-1]['actions_per_s']:.1f} actions/s, client p50 {turns[-1]['p50_ms']:.1f} ms "
                f"p99 {turns[-1]['p99_ms']:.1f} ms")
        server.stop()
        replica_stats = {rid: PolicyClient(r["url"]).stats() for rid, r in replicas.items()}
        for rid, s in replica_stats.items():
            log(f"[fleet] replica {rid}: {s['served']} served in {s['batches']} batches (rungs {s['rungs']}), "
                f"launches {s['kernel_launches']}, compiled {s['compile_executables']}")
        launches_ok = all(s["kernel_launches"]["rssm"] >= s["batches"] > 0 and s["kernel_launches"]["gru"] == 0
                          for s in replica_stats.values())

        # -- the kill drill --------------------------------------------------------------------
        rng = np.random.default_rng(56)
        spec = single.player.obs_spec
        draw = lambda: {k: rng.integers(0, 256, s, dtype=np.uint8) if d == "uint8"  # noqa: E731
                        else rng.standard_normal(s).astype(np.float32) for k, (s, d) in spec.items()}
        router = PolicyClient(router_url, packed=True, timeout=120, retries=6, retry_base_s=0.2)
        # the victim: the replica the router's rendezvous hash gives most of
        # the drill's sessions; the pinned session is one it also gives it
        rids = sorted(replicas)
        homes = [assign_replica(f"k{i}", rids) for i in range(SERVE_SESSIONS)]
        home = max(rids, key=homes.count)
        pin = next(f"pin-{j}" for j in range(1000) if assign_replica(f"pin-{j}", rids) == home)
        for _ in range(2):  # the pinned session's first steps, alone
            router.act(draw(), session=pin, greedy=True)
        carry = _carry_rows(PolicyClient(replicas[home]["url"]).session_carry(pin))
        errors, done, lock, streamed = [], [], threading.Lock(), [0]

        def stream(i: int) -> None:
            client = PolicyClient(router_url, packed=True, timeout=120, retries=6, retry_base_s=0.2)
            local = np.random.default_rng(i)
            try:
                for step in range(FLEET_KILL_STEPS):
                    obs = {k: local.integers(0, 256, s, dtype=np.uint8) if d == "uint8"
                           else local.standard_normal(s).astype(np.float32) for k, (s, d) in spec.items()}
                    if not valid(client.act(obs, session=f"k{i}", greedy=(i + step) % 2 == 0)):
                        raise AssertionError("invalid action")
                    with lock:
                        streamed[0] += 1
                with lock:
                    done.append(i)
            except BaseException as e:  # noqa: BLE001 - the gate is that none fails
                errors.append(f"k{i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=stream, args=(i,), daemon=True) for i in range(SERVE_SESSIONS)]
        for t in threads:
            t.start()
        while streamed[0] < SERVE_SESSIONS * FLEET_KILL_STEPS // 3 and not errors:  # mid-stream
            time.sleep(0.002)
        t_kill, streamed_at_kill = time.perf_counter(), streamed[0]
        os.kill(replica_pids[home], signal.SIGKILL)
        for t in threads:
            t.join(300)
        # the rollout's snapshot is staged while the slot respawns
        root = served_dir / "checkpoint"
        step = checkpoint_step(latest_checkpoint(root)) + 1
        staged = _stage_snapshot(torch, [*XL_SERVE, FUSED, f"seed={FLEET_ROLL_SEED}"], run_root / "fleet_staging", step)
        after_kill = router.stats()
        while after_kill["respawns"] < 1 or after_kill["healthy"] < FLEET_REPLICAS:
            if time.perf_counter() - t_kill > 300:
                raise AssertionError(f"[fleet] the killed slot did not come back: {after_kill}")
            time.sleep(0.1)
            after_kill = router.stats()
        respawn_s = time.perf_counter() - t_kill
        log(f"[fleet] SIGKILL of {home} (pid {replica_pids[home]}, {homes.count(home)} of the sessions) after "
            f"{streamed_at_kill} of {SERVE_SESSIONS} sessions x {FLEET_KILL_STEPS} steps: {len(done)} sessions complete, {len(errors)} failed {errors[:3]}; routed "
            f"{after_kill['routed']}, failovers {after_kill['failovers']}, migrations {after_kill['migrations']}, "
            f"ejects {after_kill['ejects']}; the slot respawned and routable {respawn_s:.1f} s after the kill")
        replicas = after_kill["per_replica"]
        replica_pids = {rid: _replica_pid(int(r["url"].rsplit(":", 1)[1]), proc.pid) for rid, r in replicas.items()}

        # -- the pinned session, migrated onto its slot's new process -------------------------------
        raw = draw()
        before = {rid: PolicyClient(r["url"]).stats() for rid, r in replicas.items()}
        action = router.act(raw, session=pin, greedy=True)
        dest = next(rid for rid, r in replicas.items() if PolicyClient(r["url"]).session_carry(pin) is not None)
        if before[dest]["errors"]:
            raise AssertionError(f"[fleet] replica {dest} failed requests: {before[dest]}")
        migrated = (_carry_rows(PolicyClient(replicas[dest]["url"]).session_carry(pin)), action)
        expected = _local_step(single, carry, raw, seed0 + before[dest]["batches"] + 1)
        carry_same = _same_step(migrated, expected)
        log(f"[fleet] session {pin} ({home} before the kill) stepped alone on {dest} after the respawn: carry and "
            f"action {'equal' if carry_same else 'NOT equal'} bit for bit to the step from its migrated carry in "
            f"this process (rung 1, the same seed); migrations {router.stats()['migrations']}")
        single.stop()
        del single, server
        gc.collect()
        torch.cuda.empty_cache()

        # -- a rolling reload under 16 sessions ------------------------------------------------------------
        compiled = {rid: PolicyClient(r["url"]).stats()["compile_executables"] for rid, r in replicas.items()}
        stop, roll_errors, answered = threading.Event(), [], [0]

        def load(i: int) -> None:
            client = PolicyClient(router_url, packed=True, timeout=120, retries=6, retry_base_s=0.2)
            local = np.random.default_rng(100 + i)
            try:
                while not stop.is_set():
                    obs = {k: local.integers(0, 256, s, dtype=np.uint8) if d == "uint8"
                           else local.standard_normal(s).astype(np.float32) for k, (s, d) in spec.items()}
                    if not valid(client.act(obs, session=f"r{i}", greedy=i % 2 == 0)):
                        raise AssertionError("invalid action")
                    with lock:
                        answered[0] += 1
            except BaseException as e:  # noqa: BLE001 - the gate is that none fails
                roll_errors.append(f"r{i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=load, args=(i,), daemon=True) for i in range(SERVE_SESSIONS)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        t_land = time.perf_counter()
        os.replace(staged, root / staged.name)
        rolled = router.stats()
        while rolled["rolling_reloads"] < 1 and not roll_errors:
            if time.perf_counter() - t_land > 300:
                raise AssertionError(f"[fleet] the rollout did not finish: {rolled}")
            time.sleep(0.1)
            rolled = router.stats()
        roll_s = time.perf_counter() - t_land
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(120)
        rolled = router.stats()
        after = {rid: PolicyClient(r["url"]).stats() for rid, r in replicas.items()}
        recaptured = {rid: after[rid]["compile_executables"] - compiled[rid] for rid in after}
        log(f"[fleet] rolling reload of step {step} under {SERVE_SESSIONS} sessions: done {roll_s:.2f} s after the "
            f"commit, {answered[0]} requests answered, {len(roll_errors)} failed {roll_errors[:3]}; replicas reloaded "
            f"{rolled['replicas_reloaded']}, halts {rolled['reload_halts']}, fleet step {rolled['fleet_step']}; "
            f"captures during it {recaptured}; replica steps {[a['checkpoint_step'] for a in after.values()]}")
        for line in (line for line in list(child.lines) if "halted:" in line):
            log(f"[fleet] the router said: {line.rstrip()}")
        fresh = PolicyService.from_checkpoint(root / staged.name, ["serve.watch_commits=False"])
        fresh.warm_up()
        rows = tuple(np.zeros(s, np.dtype(d)) for s, d in fresh.player.carry_spec)
        raw = draw()
        fresh_same = {}
        for rid, r in replicas.items():
            got_carry, got_action, seed = _replica_step(torch, r["url"], f"fresh-{rid}", rows, raw, seed0)
            fresh_same[rid] = _same_step((got_carry, got_action), _local_step(fresh, rows, raw, seed))
        log(f"[fleet] each replica's step after the rollout against a fresh service on step {step}: "
            + ", ".join(f"{rid} {'equal' if same else 'NOT equal'}" for rid, same in fresh_same.items())
            + " bit for bit")
        del fresh
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        rc = _stop_child(proc, signal.SIGTERM, timeout=120)
        orphans = [pid for pid in replica_pids.values() if Path(f"/proc/{pid}").exists()]
        for pid in orphans:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
    log(f"[fleet] SIGTERM to the fleet: exit {rc}, replicas left running {orphans}")
    fleet = [t for t in turns if t["where"] == "fleet"]
    one = [t for t in turns if t["where"] == "single"]
    ok = (launches_ok and not errors and len(done) == SERVE_SESSIONS and after_kill["migrations"] >= homes.count(home)
          and carry_same and not roll_errors and rolled["replicas_reloaded"] >= FLEET_REPLICAS
          and rolled["reload_halts"] == 0 and not any(recaptured.values())
          and all(a["checkpoint_step"] == step for a in after.values()) and all(fresh_same.values())
          and rc == 0 and not orphans)
    if not ok:
        raise AssertionError("[fleet] a check of phase 56 failed (see the lines above)")
    return {"startup_s": startup_s, "turns": turns, "replicas": {rid: {k: s[k] for k in ("served", "batches",
                                                                                          "kernel_launches", "rungs")}
                                                                 for rid, s in replica_stats.items()},
            "kill": {"sessions_done": len(done), "errors": len(errors), "respawn_s": respawn_s,
                     "migrations": after_kill["migrations"], "failovers": after_kill["failovers"]},
            "carry_bit_for_bit": carry_same, "reload": {"seconds": roll_s, "answered": answered[0],
                                                        "replicas_reloaded": rolled["replicas_reloaded"],
                                                        "fresh_bit_for_bit": fresh_same},
            "fleet_actions_per_s": [t["actions_per_s"] for t in fleet],
            "single_actions_per_s": [t["actions_per_s"] for t in one],
            "launches": {"rssm": sum(s["kernel_launches"]["rssm"] for s in replica_stats.values()),
                         "gru": sum(s["kernel_launches"]["gru"] for s in replica_stats.values())}}


def phase_deploy(torch, run_root: Path, snapshot: Path, run_twin: dict, served_dir: Path) -> dict:
    """Phases 54-56; the servers of 55 and 56 start first, so that their
    starts overlap phase 54."""
    t0 = time.perf_counter()
    jax_child, fleet = jax_serve_child(run_root), fleet_child(served_dir)
    try:
        out = {"registry": phase_registry(torch, snapshot, run_root, run_twin),
               "jax_snapshot": phase_jax_snapshot(torch, run_root, jax_child),
               "fleet": phase_fleet(torch, run_root, served_dir, fleet)}
    finally:
        for child in (jax_child, fleet):
            _stop_child(child.proc, signal.SIGTERM, timeout=120)
    out["seconds"] = time.perf_counter() - t0
    log(f"[deploy] phases 54-56 in {out['seconds']:.1f} s")
    return out


def deploy_summary(d: dict) -> dict:
    f = d["fleet"]
    return {"seconds": d["seconds"], "registry_s": d["registry"]["seconds"],
            "jax_snapshot": {k: d["jax_snapshot"][k] for k in ("served", "batches", "launches", "served_h_err",
                                                                "errs")},
            "fleet": {k: f[k] for k in ("startup_s", "turns", "replicas", "kill", "carry_bit_for_bit", "reload")}}


# -- population training (phases 57-58) and the run supervisor (phase 59) ------
POP_ENVS = 256  # each member's env shard
POP_MEMBERS = (8, 4)  # phase 57's two PPO populations: launches must not grow with P
# PPO's recipe (MLP 64 x 2, rollout 128, 10 epochs of 8 minibatches of a
# member's 32,768 rows) for every member; PBT every 2 updates past a warm-up
# of 2, so 6 updates hold the exploits at updates 4 and 6; every phase after
# the first under steady_guard
POP_PPO = ("exp=ppo", "env=jax_cartpole", *ENVS_COMMON, f"env.num_envs={POP_ENVS}", "algo.per_rank_batch_size=4096",
           "population.exploit_every=2", "population.warmup=2", "buffer.transfer_guard=True", "metric.log_level=1")
POP_UPDATES = 6
# A2C (the stacked RMSprop) at P = 4, 3 updates, exploits every update past the first
POP_A2C = ("exp=a2c", "env=jax_cartpole", *ENVS_COMMON, f"env.num_envs={POP_ENVS}", "population.size=4",
           "population.exploit_every=1", "population.warmup=1", "buffer.transfer_guard=True", "metric.log_level=1",
           f"algo.total_steps={3 * 4 * POP_ENVS * 128}")
# PPO through the CNN on multiroom, a level pinned per member; episodes of 16
# steps, so every member's rows autoreset inside each rollout of 32
POP_LEVELS = (0.0, 1.0, 2.0, 3.0)
POP_MULTIROOM = ("exp=ppo", "env=jax_multiroom", *ENVS_COMMON, "env.num_envs=64", "algo.cnn_keys.encoder=[rgb]",
                 "algo.mlp_keys.encoder=[]", "algo.rollout_steps=32", "algo.per_rank_batch_size=1024",
                 "algo.update_epochs=2", "env.max_episode_steps=16", "population.size=4",
                 f"population.levels=[{','.join(str(x) for x in POP_LEVELS)}]", "population.exploit_every=2",
                 "population.warmup=1", "buffer.transfer_guard=True", "metric.log_level=1",
                 f"algo.total_steps={3 * 4 * 64 * 32}")
POP_PARITY = ("exp=ppo", "env=jax_cartpole", f"env.num_envs={POP_ENVS}", "algo.rollout_steps=32",
              "algo.per_rank_batch_size=2048", "algo.update_epochs=2", "algo.ent_coef=0.01", "algo.max_grad_norm=0.5",
              "algo.optimizer.name=sgd", "algo.optimizer.lr=0.01", "algo.optimizer.momentum=0.9", "population.size=4",
              "population.warmup=0", "population.exploit_every=1", "seed=58")


def _population_run(torch, tag: str, overrides, log_dir: Path, profiled: bool = True) -> dict:
    """A population through ``cli.run``: every population phase (the route
    ``<algo>.population_phase``) timed by CUDA events around it (the phases
    after the first run under ``steady_guard``, where the host may not wait),
    its host calls (graph launches and input copies) counted; the kernels'
    launch counts zeroed before and read after (none may launch); then the
    captured phase held against eager execution (:func:`_replay_check`),
    its eager phase under the profiler when ``profiled`` (the device kernels
    of a phase); the summary and the route read back."""
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.algos.ppo import population as pop_mod
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.ops import gru, rssm
    from sheeprl_tpu_torch.parallel.compile import GraphFunction

    routes, calls = [], []
    init, call = pop_mod.PopulationRoute.__init__, GraphFunction.__call__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        routes.append(self)

    def timed(self, *args, **kwargs):
        if not self.name.endswith(".population_phase"):
            return call(self, *args, **kwargs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        host0 = self.replays + self.input_copies
        start.record()
        out = call(self, *args, **kwargs)
        end.record()
        calls.append({"start": start, "end": end, "host_calls": self.replays + self.input_copies - host0,
                      "graphs": self.graphs, "eager_reason": self.eager_reason})
        return out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rssm.LAUNCHES["rssm"] = gru.LAUNCHES["gru"] = 0
    pop_mod.PopulationRoute.__init__, GraphFunction.__call__ = record, timed
    t0 = time.perf_counter()
    try:
        run([*overrides, f"log_dir={log_dir}"])
    finally:
        pop_mod.PopulationRoute.__init__, GraphFunction.__call__ = init, call
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"rssm": rssm.LAUNCHES["rssm"], "gru": gru.LAUNCHES["gru"]}
    if any(counts.values()) or len(routes) != 1 or len(calls) < 2:
        raise AssertionError(f"[{tag}] launches {counts}, {len(routes)} routes, {len(calls)} population phases")
    route = routes[0]
    P, B, T = route.size, route.num_envs, route.trainer.T
    device_ms = [c["start"].elapsed_time(c["end"]) for c in calls]
    periods = [a["start"].elapsed_time(b["start"]) for a, b in zip(calls, calls[1:])]
    steady = statistics.median(periods[1:]) if len(periods) > 1 else periods[0]
    summary = json.loads(next(log_dir.glob("**/population_summary.json")).read_text())
    host_calls = [c["host_calls"] for c in calls[1:]]
    eager_ms = kernels = None

    def eager():
        nonlocal eager_ms, kernels
        if not profiled:
            return route.step._fn()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = route.step._fn()
            torch.cuda.synchronize()
        eager_ms, kernels = _log_profile(tag, prof, statistics.median(device_ms[1:]),
                                         "one population phase run eagerly", "(the median replayed phase's device time)")
        return out

    replay = _replay_check(torch, tag, route, eager)
    spread = {k: max(v) / min(v) if min(v) > 0 else float("nan") for k, v in summary["hyperparams"].items()}
    out = {"members": P, "envs": B, "steps": T, "phases": len(calls), "device_ms": device_ms, "period_ms": periods,
           "env_steps_per_s": P * B * T / (steady / 1e3), "host_calls_per_phase": host_calls,
           "kernels_per_phase": kernels, "eager_device_ms": eager_ms, "graphs": calls[-1]["graphs"],
           "eager_reason": calls[-1]["eager_reason"], "guarded_phases": len(calls) - 1, "summary": summary,
           "hp_spread": spread, "peak_bytes": torch.cuda.max_memory_allocated(), "wall_s": wall, "route": route,
           "counts": counts, "replay": replay}
    log(f"[{tag}] {P} members x {B} envs x {T} steps: {len(calls)} population phases in a {wall:.1f} s run; device "
        f"ms per phase {', '.join(f'{x:.1f}' for x in device_ms)}; steady period {steady:.1f} ms = "
        f"{out['env_steps_per_s']:.0f} env steps/s; the phase "
        f"{'captured as one CUDA graph' if out['graphs'] else 'eager (' + (out['eager_reason'] or 'on the CPU') + ')'}, "
        f"{host_calls} host calls per phase after the first, {kernels or 'not counted:'} device kernels in one "
        f"eager phase; "
        f"{len(calls) - 1} phases under steady_guard with no guard error; exploit events "
        f"{summary['exploit_events']}, fitness {', '.join(f'{x:.1f}' for x in summary['fitness'])}, "
        f"hyperparameter spread (max/min) {', '.join(f'{k} {v:.3f}' for k, v in spread.items())}; peak device "
        f"memory {out['peak_bytes'] / 2**30:.2f} GiB")
    return out


def _population_state(route) -> list:
    """Every tensor a population phase updates in place: the stacked
    parameters, the optimizer state, the member carry (envs, episode
    records, update counters), fitness, episode counts, exploits and
    hyperparameters."""
    return [*route.agent.tensors(), *route.optimizer.tensors(), *_tensor_leaves(route.pop),
            *_tensor_leaves(route.hp)]


def _replay_check(torch, tag: str, route, eager) -> dict:
    """The captured population phase against eager execution: from the
    run's final state with the update counter set so that the next phase
    exploits, and the same generator states, one eager phase (``eager()``,
    the route's ``step._fn``) and one replay of the captured graph
    (``route.step``).  Every tensor the phase updates, and the losses, bit
    for bit; else the parameters' changes and the losses within phase 17's
    tolerance, every other float tensor's change likewise, the integer
    tensors equal.  The run's final state is put back after."""
    step, pbt = route.step, route.pbt
    state = _population_state(route)
    final = [t.detach().clone() for t in state]
    update = route.pop["members"]["update"]
    if pbt.exploit_every > 0:  # the gate opens where the phase's new counter is a multiple past the warm-up
        gate = (int(update[0]) // pbt.exploit_every + 1) * pbt.exploit_every
        while gate <= pbt.warmup:
            gate += pbt.exploit_every
        with torch.no_grad():
            update.fill_(gate - 1)
    start = [t.detach().clone() for t in state]
    gens = [g.get_state() for g in step.generators]
    exploits0 = int(route.pop["exploits"])

    def restore(tensors):
        with torch.no_grad():
            for t, s in zip(state, tensors):
                t.copy_(s)

    def run(fn):
        restore(start)
        for g, s in zip(step.generators, gens):
            g.set_state(s)
        losses, _ = fn()
        torch.cuda.synchronize()
        return losses.detach().clone(), [t.detach().clone() for t in state]

    ref_losses, ref = run(eager)
    losses, got = run(step)
    exploited = int(route.pop["exploits"]) - exploits0
    restore(final)
    bit = [torch.equal(a, b) for a, b in zip(ref, got)]
    same_losses = torch.equal(ref_losses, losses)
    names = list(route.agent.params)
    n = len(names)
    diffs = change_diffs(torch, dict(zip(names, start)), dict(zip(names, got)), losses.cpu().numpy().reshape(-1),
                         dict(zip(names, ref)), ref_losses.cpu().numpy().reshape(-1))
    others = []
    for s0, a, b in zip(start[n:], ref[n:], got[n:]):
        if not a.is_floating_point():
            others.append(bool(torch.equal(a, b)))
        else:
            change = float((a.double() - s0.double()).norm())
            others.append(float((b.double() - a.double()).norm()) <= CARD_PARITY_TOL_PARAM * max(change, 1e-30))
    log(f"[{tag}] the captured phase against eager execution, from one state and one generator state with the "
        f"exploit gate open ({exploited} members copied): {sum(bit)} of {len(bit)} updated tensors and the "
        f"losses {'bit for bit' if same_losses else 'not bit for bit'} ({sum(bit[:n])} of {n} parameters); "
        f"{show_diffs(diffs)}")
    if not (all(bit) and same_losses) and not (within_parity(diffs) and all(others)):
        raise AssertionError(f"{tag}: the replayed population phase disagrees with eager execution")
    if pbt.exploit_every > 0 and exploited != pbt.n_select:
        raise AssertionError(f"{tag}: {exploited} members copied in a phase whose gate was open")
    return {"bit_for_bit": sum(bit), "tensors": len(bit), "losses_bit_for_bit": same_losses,
            "param_l2": diffs["param_l2"], "loss_rel": diffs["loss_rel"], "exploited": exploited}


def phase_population_train(torch, run_root: Path) -> dict:
    """Phase 57: PPO populations of 8 and 4 members through ``cli.run`` on
    ``jax_cartpole`` (launches per phase must not grow with P), an A2C
    population (the stacked RMSprop on the card), and a PPO population on
    ``jax_multiroom`` with a level pinned per member through autoreset."""
    t0 = time.perf_counter()
    runs = {}
    for members in POP_MEMBERS:
        overrides = (*POP_PPO, f"population.size={members}",
                     f"algo.total_steps={POP_UPDATES * members * POP_ENVS * 128}")
        runs[f"ppo_p{members}"] = r = _population_run(torch, f"population-ppo-p{members}", overrides,
                                                      run_root / f"ppo_p{members}")
        if r["summary"]["exploit_events"] < 2 * r["route"].pbt.n_select or r["phases"] != POP_UPDATES:
            raise AssertionError(f"P={members}: {r['phases']} phases, {r['summary']['exploit_events']} exploits")
        if r["graphs"] and any(n != 1 for n in r["host_calls_per_phase"]):
            raise AssertionError(f"P={members}: a replayed phase made {r['host_calls_per_phase']} host calls")
        if not any(v > 1.0 for v in r["hp_spread"].values() if np.isfinite(v)):
            raise AssertionError(f"P={members}: the members' hyperparameters do not differ: {r['hp_spread']}")
    big, small = (runs[f"ppo_p{m}"] for m in POP_MEMBERS)
    ratio = big["kernels_per_phase"] / small["kernels_per_phase"]
    log(f"[population] device kernels per phase: P={POP_MEMBERS[0]} {big['kernels_per_phase']}, "
        f"P={POP_MEMBERS[1]} {small['kernels_per_phase']} (ratio {ratio:.3f}); host calls per phase "
        f"{big['host_calls_per_phase'][-1]} and {small['host_calls_per_phase'][-1]}")
    if abs(ratio - 1.0) > 0.1:
        raise AssertionError(f"launches per population phase grew with P: {ratio:.3f}")
    runs["a2c_p4"] = a2c = _population_run(torch, "population-a2c-p4", POP_A2C, run_root / "a2c_p4", profiled=False)
    if a2c["summary"]["exploit_events"] < 1:
        raise AssertionError(f"A2C population: no exploit ({a2c['summary']})")
    runs["multiroom_p4"] = mr = _population_run(torch, "population-multiroom-p4", POP_MULTIROOM,
                                                run_root / "multiroom_p4", profiled=False)
    carry = mr["route"].pop
    want = torch.tensor(POP_LEVELS).repeat_interleave(mr["envs"]).to(carry["members"]["env"].level.device)
    episodes = carry["ep_count"].cpu().tolist()
    if not torch.equal(carry["members"]["env"].level, want) or min(episodes) < mr["envs"]:
        raise AssertionError(f"multiroom levels after autoreset {carry['members']['env'].level.unique().tolist()}, "
                             f"episodes per member {episodes}")
    log(f"[population-multiroom-p4] each member's level still pinned after {sum(episodes)} episodes "
        f"({episodes} per member, every row reset at least once): levels {list(POP_LEVELS)}")
    for r in runs.values():
        r.pop("route")
    runs["seconds"] = time.perf_counter() - t0
    return runs


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def phase_population_parity(torch) -> dict:
    """Phase 58: one PPO population window (4 members x 256 envs x 32 steps,
    2 epochs of 4 minibatches, the exploit gate open) on the card and on the
    CPU from the same stacked state and the same draws (action noise, reset
    draws, minibatch orders, explore factors), stepping with SGD with
    momentum: the parameters' changes and the losses within phase 17's
    tolerance, the momentum buffers' changes likewise, fitness, episode
    counts, exploits and hyperparameters equal."""
    from sheeprl_tpu_torch.algos.ppo.agent import action_noise
    from sheeprl_tpu_torch.algos.ppo.population import PopulationRoute
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer
    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.envs.device import env_from_cfg
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.population import perturbation_factors
    from sheeprl_tpu_torch.population.members import member_permutations

    def route(accelerator: str):
        cfg = compose([*POP_PARITY, f"fabric.accelerator={accelerator}", "metric.log_level=0"])
        fabric = build_fabric(cfg)
        env = env_from_cfg(cfg)
        dims, cont = spaces_to_dims(env.action_space)
        gens = {k: torch.Generator(fabric.device).manual_seed(i) for i, k in enumerate(("train", "player", "env"))}
        return PopulationRoute(fabric, cfg, PPOTrainer, env, env.observation_space, env.action_space, dims, cont,
                               gens, {}, 1), dims, cont

    cpu, dims, cont = route("cpu")
    card, _, _ = route("cpu" if CARD == "cpu" else "gpu")
    card.agent.load_state_dict(_to(cpu.agent.state_dict(), CARD))
    with torch.no_grad():
        for dst, src in zip(card.pop["members"]["env"], cpu.pop["members"]["env"]):
            dst.copy_(src)
        for k in cpu.hp:
            card.hp[k].copy_(cpu.hp[k])
    P, B, T = cpu.size, cpu.num_envs, cpu.trainer.T
    single = cpu.trainer.single
    gen = torch.Generator().manual_seed(58)
    rows = torch.zeros(P * B, sum(dims))
    draws = {"members": {
        "noise": [action_noise(rows, dims, cont, "auto", gen) for _ in range(T)],
        "reset": [cpu.venv.env.draw_reset(P * B, gen, torch.device("cpu")) for _ in range(T)],
        "perms": torch.stack([member_permutations(gen, P, T * B, single.num_minibatches * single.batch_size)
                              for _ in range(single.update_epochs)], dim=1)},
        "factors": perturbation_factors(cpu.pbt, cpu.hp, gen)}
    start = {k: v.detach().clone() for k, v in cpu.agent.state_dict().items()}
    mom0 = {k: s["momentum_buffer"].clone() for k, s in cpu.optimizer.state.items()}
    t0 = time.perf_counter()
    cpu_losses, _ = cpu.step._fn(draws)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_losses, _ = card.step._fn(_to(draws, CARD))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    params = {k: v.detach().cpu() for k, v in card.agent.state_dict().items()}
    got = change_diffs(torch, start, params, card_losses.cpu().numpy().reshape(-1),
                       {k: v.detach() for k, v in cpu.agent.state_dict().items()},
                       cpu_losses.numpy().reshape(-1))
    mom = change_diffs(torch, mom0, {k: s["momentum_buffer"].cpu() for k, s in card.optimizer.state.items()},
                       np.ones(1), {k: s["momentum_buffer"] for k, s in cpu.optimizer.state.items()}, np.ones(1))
    same = {k: bool(torch.equal(card.pop[k].cpu(), cpu.pop[k])) for k in ("fitness", "ep_count", "exploits")}
    hp_diff = max(float((card.hp[k].cpu() - cpu.hp[k]).abs().max() / cpu.hp[k].abs().max().clamp_min(1e-30))
                  for k in cpu.hp)
    log(f"[population-parity] one window of {P} members x {B} envs x {T} steps (SGD lr 0.01, momentum 0.9; CPU "
        f"{cpu_s:.1f} s, card {card_s:.2f} s, both eager), card vs CPU: {show_diffs(got)}; momentum buffers' "
        f"changes rel L2 diff {mom['param_l2']:.3g}; fitness, episode counts, exploits equal {same} (exploits "
        f"{int(cpu.pop['exploits'])}, fitness {', '.join(f'{x:.2f}' for x in cpu.pop['fitness'].tolist())}); "
        f"hyperparameters max rel diff {hp_diff:.3g}; tolerance L2 {CARD_PARITY_TOL_PARAM}, losses "
        f"{CARD_PARITY_TOL_LOSS}")
    if not (within_parity(got) and mom["param_l2"] <= CARD_PARITY_TOL_PARAM and all(same.values())
            and hp_diff <= 1e-6 and int(cpu.pop["exploits"]) > 0):
        raise AssertionError("the population window on the card disagrees with the same window on the CPU")
    return {**got, "momentum_l2": mom["param_l2"], "same": same, "hp_rel": hp_diff, "cpu_s": cpu_s,
            "card_s": card_s}


# DreamerV3-S with the GRU kernel (phase 10's recipe: 2 updates at step 65)
# under the supervisor: a commit at step 68, a fatal env.step fault at step
# 72 (past the first window); the rerun resumes from step 68, waits
# learning_starts again (as JAX's loop does on a resume), trains at step 134
# and ends at 135, never reaching invocation 72 again
SUPERVISED_COMMIT, SUPERVISED_FAULT, SUPERVISED_TOTAL = 68, 72, 135
SUPERVISED_S = (*(o for o in S_TRAIN if not o.startswith(("checkpoint.every", "buffer.checkpoint",
                                                          "algo.total_steps"))),
                "buffer.checkpoint=True", HOST_RING, "env.restart_on_exception=False", "metric.log_level=1",
                f"algo.total_steps={SUPERVISED_TOTAL}", "supervisor.backoff_base_s=0.5",
                "supervisor.poll_interval_s=1.0")
SUPERVISED_KERNEL = "gru"  # the kernel every window of the supervised children launches
BREAKER_FAULT = 10  # the breaker drill's fault: before any commit, so a rerun dies at the same step


def supervised_child_cmd(events_path: Path):
    """The supervisor's command for phase 59's child: this script's
    ``--supervised-child`` around ``cli.run``."""
    return lambda argv: [sys.executable, str(ROOT / "chip_smoke.py"), "--supervised-child", str(events_path), *argv]


def _fault_plan(at: int) -> str:
    return json.dumps({"plan": [{"site": "env.step", "kind": "raise", "at": at}]})


def supervised_child(torch, argv) -> int:
    """``--supervised-child EVENTS OVERRIDES``: ``cli.run`` with its train
    windows and its kernel launches appended to ``EVENTS`` (one JSON line
    each, wall-clock stamped), for phase 59's supervisor to launch."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.ops import gru, rssm

    path, argv = argv[0], argv[1:]

    def emit(event: dict) -> None:
        with open(path, "a") as f:
            f.write(json.dumps({"pid": os.getpid(), "t": time.time(), **event}) + "\n")

    emit({"event": "start"})
    try:
        with _window_log(lambda w: emit({"event": "window", **w})):
            run(list(argv))
    finally:
        emit({"event": "exit", "rssm": rssm.LAUNCHES["rssm"], "gru": gru.LAUNCHES["gru"]})
    return 0


def replay_tail_check(exp_root: Path) -> dict:
    """ROADMAP.md §C 4 on the card's run: the newest committed snapshot
    under ``exp_root`` holds its host ring (``buffer.checkpoint=True``,
    ``buffer.device=False``) with every env stream's write-head row marked
    ``truncated`` (``utils/callback.py``), as JAX's ``CheckpointCallback``
    saves it; ``terminated`` there is what the env returned."""
    from sheeprl_tpu_torch.checkpoint.protocol import list_checkpoints, load_step_dir

    newest = max((d for root in exp_root.glob("*/version_*/checkpoint") for d in list_checkpoints(root)),
                 key=lambda d: d.name)
    subs = load_step_dir(newest, map_location="cpu")["rb"]["buffers"]
    tails = [float(sub["buffer"]["truncated"][(int(sub["pos"]) - 1) % int(sub["buffer_size"])].max())
             for sub in subs]
    log(f"[replay-tail] {newest.name} of the supervised DreamerV3-S run: {len(subs)} env stream(s), the write-head "
        f"row's truncated {tails}")
    if not subs or tails != [1.0] * len(subs):
        raise AssertionError(f"[replay-tail] the committed ring's tail does not read as truncated: {tails}")
    return {"snapshot": newest.name, "tail_truncated": tails}


def start_breaker_drill(run_root: Path):
    """Phase 59's breaker drill, started early (its children crash in their
    prefill and barely touch the card): ``python -m
    sheeprl_tpu_torch.supervisor`` over the supervised recipe with the fault
    before any commit, its output to a file.  Returns the process, its
    experiment root and its output's path."""
    breaker_dir = run_root / "breaker"
    breaker_dir.mkdir(parents=True, exist_ok=True)
    argv = [*SUPERVISED_S, "checkpoint.every=1000000000", f"log_dir={breaker_dir}", "root_dir=breaker"]
    output = breaker_dir / "output.log"
    with open(output, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "sheeprl_tpu_torch.supervisor", *argv], cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT, env={**os.environ,
                                                               "SHEEPRL_FAULT_PLAN": _fault_plan(BREAKER_FAULT)})
    return proc, breaker_dir / "breaker", output


def phase_supervisor(torch, run_root: Path, breaker=None) -> dict:
    """Phase 59: the supervisor over a DreamerV3-S child (``use_pallas``: the
    GRU kernel) whose env raises past a committed save: the crash classified
    ``transient`` from its postmortem, the restart with
    ``checkpoint.resume_from=auto``, the rerun to the full step count, exit 0
    and two episodes in ``supervisor_log.jsonl``; then ``python -m
    sheeprl_tpu_torch.supervisor`` over the same fault planted before any
    commit, so it recurs at the same step: the breaker opens, exit 2."""
    from sheeprl_tpu_torch.checkpoint.protocol import checkpoint_step, list_checkpoints
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.supervisor import EXIT_BREAKER, EXIT_OK, Supervisor

    t0 = time.perf_counter()
    log_dir = run_root / "supervised"
    events_path = log_dir / "events.jsonl"
    log_dir.mkdir(parents=True, exist_ok=True)
    argv = [*SUPERVISED_S, f"checkpoint.every={SUPERVISED_COMMIT}", f"log_dir={log_dir}", "root_dir=supervised"]
    sup = Supervisor(compose(argv), argv, handle_signals=False, child_cmd=supervised_child_cmd(events_path),
                     child_env={"SHEEPRL_FAULT_PLAN": _fault_plan(SUPERVISED_FAULT)})
    rc = sup.run()
    episodes = [json.loads(line) for line in open(sup.audit_path)]
    events = [json.loads(line) for line in open(events_path)]
    pids = list(dict.fromkeys(e["pid"] for e in events))
    by_child = [[e for e in events if e["pid"] == pid] for pid in pids]
    exits = [next(e for e in child if e["event"] == "exit") for child in by_child]
    windows = [[e for e in child if e["event"] == "window"] for child in by_child]
    steps = sorted(checkpoint_step(d) for root in (log_dir / "supervised").glob("*/version_*/checkpoint")
                   for d in list_checkpoints(root))
    kinds = [(e["classification"], e["action"]) for e in episodes]
    launches = {k: sum(e[k] for e in exits) for k in ("rssm", "gru")}
    doc = json.loads(Path(episodes[0]["postmortem"]).read_text()) if episodes and episodes[0]["postmortem"] else {}
    injected = any(e.get("kind") == "fault.injected" and e.get("site") == "env.step" for e in doc.get("events", []))
    if (rc != EXIT_OK or kinds != [("transient", "restart"), ("success", "done")] or not injected
            or len(by_child) != 2 or not steps or steps[-1] != SUPERVISED_TOTAL or SUPERVISED_COMMIT not in steps
            or not all(windows) or any(w[k] <= 0 if k == SUPERVISED_KERNEL else w[k]
                                       for ws in windows for w in ws for k in ("rssm", "gru"))
            or any(v <= 0 if k == SUPERVISED_KERNEL else v for k, v in launches.items())):
        raise AssertionError(f"supervised run: rc {rc}, episodes {kinds}, postmortem fault {injected}, "
                             f"{len(by_child)} children, committed steps {steps}, windows {windows}, launches "
                             f"{launches}")
    crash_to_update = windows[1][0]["t"] - exits[0]["t"]
    tail = replay_tail_check(log_dir / "supervised")
    log(f"[supervisor] DreamerV3-S (use_pallas) supervised: episode 0 crashed at env step {SUPERVISED_FAULT} "
        f"(signature {episodes[0]['signature']}), classified {episodes[0]['classification']} "
        f"from its postmortem, restarted with resume_from=auto in {episodes[0]['next_delay_s']:.2f} s; the rerun "
        f"resumed at step {SUPERVISED_COMMIT} and committed step {steps[-1]} (all committed {steps}); "
        f"{crash_to_update:.1f} s from the crash to the restarted child's first update; gru launches "
        f"{[e['gru'] for e in exits]} ({launches['gru']}), rssm {[e['rssm'] for e in exits]} ({launches['rssm']}); "
        f"supervisor exit {rc}")
    proc, exp_root, output = breaker or start_breaker_drill(run_root)
    try:
        proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = output.read_text()
    audit = exp_root / "supervisor_log.jsonl"
    episodes_b = [json.loads(line) for line in open(audit)] if audit.exists() else []
    b_kinds = [e["classification"] for e in episodes_b]
    if proc.returncode != EXIT_BREAKER or b_kinds != ["transient", "deterministic"] or \
            episodes_b[0]["signature"] != episodes_b[1]["signature"]:
        raise AssertionError(f"breaker drill: exit {proc.returncode}, episodes {b_kinds}, signatures "
                             f"{[e['signature'] for e in episodes_b]}:\n{out[-5000:]}")
    log(f"[supervisor] the same fault before any commit, under python -m sheeprl_tpu_torch.supervisor: episodes "
        f"{b_kinds} with the signature {episodes_b[1]['signature']} twice, the breaker open "
        f"('{episodes_b[1]['reason'][:60]}...'), exit {proc.returncode}")
    return {"rc": rc, "episodes": kinds, "steps": steps, "crash_to_update_s": crash_to_update, "replay_tail": tail,
            "launches": launches, "gru_by_child": [e["gru"] for e in exits], "breaker_rc": proc.returncode,
            "breaker": b_kinds, "seconds": time.perf_counter() - t0}


def phase_population(torch, run_root: Path, supervisor: bool = True) -> dict:
    """Phases 57-59 (phase 59's breaker drill runs beside phases 57-58).
    Without ``supervisor`` phase 59 is left to the caller (the whole run
    has it beside phase 62), which gets the started breaker drill under
    ``"breaker"`` and must end it."""
    t0 = time.perf_counter()
    breaker = start_breaker_drill(run_root / "supervisor")
    handed_on = False
    try:
        out = {"train": phase_population_train(torch, run_root / "population"),
               "parity": phase_population_parity(torch)}
        if supervisor:
            out["supervisor"] = phase_supervisor(torch, run_root / "supervisor", breaker)
        else:
            out["breaker"], handed_on = breaker, True
    finally:
        if not handed_on and breaker[0].poll() is None:
            breaker[0].kill()
            breaker[0].wait()
    out["seconds"] = time.perf_counter() - t0
    return out


def population_summary(p: dict) -> dict:
    t = p["train"]
    return {name: {k: r[k] for k in ("members", "phases", "env_steps_per_s", "kernels_per_phase",
                                     "host_calls_per_phase", "graphs", "eager_reason", "counts", "replay")}
            | {"exploit_events": r["summary"]["exploit_events"]}
            for name, r in t.items() if name != "seconds"} | {
        "parity": {k: p["parity"][k] for k in ("param_l2", "loss_rel", "momentum_l2")},
        "supervisor": {k: p["supervisor"][k] for k in ("rc", "episodes", "steps", "crash_to_update_s", "launches",
                                                        "breaker_rc")},
        "seconds": p["seconds"]}


# -- phases 60-62: envs in worker processes, action masks, a JAX snapshot resumed --
# phase 60: DV3-XL (fused RSSM kernel) on 4 dummy envs; at 4 envs a sequence of
# 64 steps can be sampled at iteration 65 (policy step 260): int(260 / 32) = 8
# updates in the first window, none more by step 264
VECENV_XL = (*(o for o in XL_TRAIN if not o.startswith(("env.sync_env", "env.num_envs"))), "env.num_envs=4", FUSED,
             "algo.replay_ratio=0.03125", "algo.total_steps=264", "algo.run_test=False")
MASK_ACTIONS = (19, 5, 7)  # MineDojo's compound action, craft argument, inventory argument
MASK_STEPS = 256  # player steps of the masked run: 64 iterations of 4 envs, no update
MASKED_XL = (*(o for o in XL_TRAIN if not o.startswith(("env.id", "env.num_envs", "algo.cnn_keys", "algo.mlp_keys",
                                                        "algo.learning_starts"))),
             "env.id=masked_dummy", "env.num_envs=4", "algo.cnn_keys.encoder=[]",
             "algo.mlp_keys.encoder=[state,mask_action_type,mask_craft_smelt,mask_equip_place,mask_destroy]",
             "algo.actor.action_masks=True", "algo.learning_starts=0", FUSED, f"algo.total_steps={MASK_STEPS}",
             "algo.replay_ratio=0.0078125", "algo.run_test=False")  # 2 updates, at the last iteration
# phase 61: DreamerV3-S (GRU kernel) with its env in a worker process; the hang
# lands once, past learning_starts (iteration 65)
WATCHDOG_S_DEADLINE = 5
WATCHDOG_S = (*(o for o in S_TRAIN if not o.startswith("env.sync_env")), "env.sync_env=False",
              f"env.step_deadline_s={WATCHDOG_S_DEADLINE}", "metric.log_level=1")
WATCHDOG_HANG_AT = 70
WATCHDOG_TOTAL = 97  # S_TRAIN's algo.total_steps
# phase 65: phase 61's SIGTERM drill on 2 envs (a worker each) with
# env.capture_video on: env 0 records episodes 0 (the build's reset), 1, 8,
# ... of 32 steps (XL_TRAIN's max_episode_steps) until the SIGTERM
VIDEO_S = ("env.num_envs=2", "env.capture_video=True")
VIDEO_EPISODE_STEPS = 32
# phase 62: the committed JAX fixture's own recipe (tools/write_jax_fixture.py's
# DV3_OVERRIDES) on the card; the resumed run trains from iteration 30
# (learning_starts after a resume: its 20 iterations on, then a sequence of 8)
FIXTURE_RESUME = (
    "exp=dreamer_v3", "env=dummy", "env.sync_env=True", "env.id=discrete_dummy", "algo=dreamer_v3_XS",
    "env.num_envs=2", "env.capture_video=False", "fabric.accelerator=gpu", "buffer.memmap=False",
    "checkpoint.async_save=False", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8",
    "algo.learning_starts=0", "algo.horizon=4", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
    "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.dense_units=16", "algo.mlp_layers=1",
    "algo.world_model.recurrent_model.recurrent_state_size=16", "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16", "algo.world_model.discrete_size=5",
    "algo.world_model.stochastic_size=4", FUSED, "env.max_episode_steps=20", "buffer.size=200", "algo.run_test=False",
    "metric/logger=csv", "metric.log_level=1", "checkpoint.every=1000000000", "checkpoint.save_last=True",
    "algo.player.device=accelerator",
)
FIXTURE_STEP = FIXTURE_DIR / "checkpoint" / "step_000000000040"
FIXTURE_LAUNCHES_PER_UPDATE = 8 + 4 + 1  # the fixture's posterior steps + imagination steps (horizon + 1)
# the first resumed update, card vs CPU from the same converted state: the ten
# losses (computed before the step) to 1e-4 relative plus 1e-5 absolute (the
# policy loss is ≈ 1e-6, all rounding); each module's parameter change to 0.1
# of its L2 norm: Adam's normalised step turns one ulp of a gradient into
# 5e-2 of a change (ROADMAP.md §C, tools/ulp_sensitivity.py)
RESUME_TOL_LOSS = (1e-4, 1e-5)
RESUME_TOL_CHANGE = 0.1


def _maps_cuda(pid: int) -> bool:
    """Whether the process has the CUDA driver library mapped (a CUDA context needs it)."""
    try:
        return "libcuda.so" in Path(f"/proc/{pid}/maps").read_text()
    except OSError:
        return False


def _compute_apps() -> list:
    """``nvidia-smi``'s processes with a context on the card (their pids as
    the card's driver sees them)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def phase_vecenv_xl(torch, run_root: Path) -> dict:
    """Phase 60 (first half): DV3-XL through ``cli.run`` on 4 dummy envs,
    the envs in worker processes (``env.sync_env=False``, under the
    step-deadline watchdog) and then on the loop thread, under cuDNN's
    deterministic algorithms: the two runs' trained tensors and losses equal
    bit for bit; updates/s, the vector env's step time (median; env steps/s
    = 4 over it), its construction time and rssm launches per update of
    each; while the workers step, none of them has the CUDA driver library
    mapped (no torch in a worker: no context can exist there), the parent
    has (``nvidia-smi``'s list is logged beside)."""
    from sheeprl_tpu_torch.utils import env as env_mod

    probe, steps, built = {}, {}, {}
    vectorize = env_mod.vectorize

    def timed_vectorize(cfg, thunks):
        t0 = time.perf_counter()
        envs = vectorize(cfg, thunks)
        tag = "sync" if cfg.env.sync_env else "async"
        built[tag], steps[tag] = time.perf_counter() - t0, []
        step = envs.step

        def timed_step(actions):
            t = time.perf_counter()
            out = step(actions)
            steps[tag].append(time.perf_counter() - t)
            if tag == "async" and len(steps[tag]) == 8:  # the loop is stepping: who holds a context now
                probe["workers"] = [p.pid for p in envs.unwrapped.processes]
                probe["apps"] = _compute_apps()
                probe["cuda_mapped"] = {pid: _maps_cuda(pid) for pid in [os.getpid(), *probe["workers"]]}
            return out

        envs.step = timed_step
        return envs

    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    modules = [m for m in sys.modules.values() if getattr(m, "vectorize", None) is vectorize]
    for m in modules:
        m.vectorize = timed_vectorize
    try:
        for sync in (False, True):
            tag = "sync" if sync else "async"
            runs[tag] = _train(torch, [*VECENV_XL, f"env.sync_env={sync}"], run_root / tag, "rssm", snapshot=False)
            step_s = statistics.median(steps[tag][1:])
            runs[tag].update(env_step_ms=step_s * 1e3, env_steps_per_s=4 / step_s, build_s=built[tag],
                             env_steps=4 * len(steps[tag]))
    finally:
        for m in modules:
            m.vectorize = vectorize
        torch.backends.cudnn.deterministic = deterministic
    a, b = ({"agent": runs[t]["trainer"].agent_state(), "opt_state": runs[t]["trainer"].opt_state()}
            for t in ("async", "sync"))
    pairs = [(x, y) for name in ("agent", "opt_state") for x, y in zip(_tensor_leaves(a[name]), _tensor_leaves(b[name]))]
    equal, n_tensors = sum(torch.equal(x, y) for x, y in pairs), len(pairs)
    del a, b, pairs
    for r in runs.values():
        del r["trainer"]
    gc.collect()
    torch.cuda.empty_cache()
    same_losses = runs["async"]["logged"] == runs["sync"]["logged"]
    workers, apps, mapped = probe.get("workers", []), probe.get("apps", []), probe.get("cuda_mapped", {})
    for tag, r in runs.items():
        log(f"[vecenv] DV3-XL, 4 envs {'in worker processes' if tag == 'async' else 'on the loop thread'}: "
            f"{r['updates_per_s']:.3f} updates/s ({r['updates']} updates, rssm launches per update "
            f"{sorted(set(r['per_update']))}); a vector step {r['env_step_ms']:.3f} ms median = "
            f"{r['env_steps_per_s']:.0f} env steps/s over {r['env_steps']} env steps; built in {r['build_s']:.2f} s; "
            f"a {r['wall_s']:.1f} s run")
    log(f"[vecenv] async vs sync, cuDNN deterministic: {equal} of {n_tensors} trained tensors and the losses "
        f"{'equal' if same_losses else 'NOT equal'} bit for bit; while the workers {workers} stepped: the CUDA "
        f"driver mapped {mapped} (this process {os.getpid()}), nvidia-smi's processes with a context {apps} "
        f"(every child process of the run's other phases among them)")
    if not (equal == n_tensors and n_tensors and same_losses and len(workers) == 4 and mapped.get(os.getpid())
            and not any(mapped.get(pid) for pid in workers)):
        raise AssertionError("[vecenv] the async run differs from the sync run, or a worker holds a CUDA context")
    return {"runs": runs, "bit_for_bit": equal, "tensors": n_tensors, "workers": workers, "compute_apps": apps}


def _masked_env_cls():
    """A dummy env with MineDojo's action branches and mask observations
    (drawn per step from its seed, at least one entry of each allowed); it
    counts every action it receives that its last masks excluded."""
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.dummy import Env
    from sheeprl_tpu_torch.envs.minedojo import FN_CRAFT, FN_DESTROY, FN_EQUIP, FN_PLACE, N_MOVEMENT_ACTIONS

    sizes = {"mask_action_type": MASK_ACTIONS[0], "mask_craft_smelt": MASK_ACTIONS[1],
             "mask_equip_place": MASK_ACTIONS[2], "mask_destroy": MASK_ACTIONS[2]}

    class MaskedDummyEnv(Env):
        checked = {"actions": 0, "excluded": 0, "with_argument": 0}

        def __init__(self, episode_len: int = 32):
            self.observation_space = spaces.Dict({"state": spaces.Box(-1, 1, (4,), np.float32),
                                                  **{k: spaces.Box(0, 1, (n,), np.float32) for k, n in sizes.items()}})
            self.action_space = spaces.MultiDiscrete(MASK_ACTIONS)
            self._len, self._t, self._rng = episode_len, 0, np.random.default_rng(0)

        def _obs(self):
            masks = {}
            for k, n in sizes.items():
                m = (self._rng.random(n) < 0.4).astype(np.float32)
                m[self._rng.integers(n)] = 1.0
                masks[k] = m
            if self._rng.random() < 0.5:  # often only functional actions, so the arguments are masked too
                masks["mask_action_type"][:N_MOVEMENT_ACTIONS] = 0.0
                masks["mask_action_type"][N_MOVEMENT_ACTIONS + self._rng.integers(7)] = 1.0
            self._masks = masks
            return {"state": self._rng.uniform(-1, 1, 4).astype(np.float32), **masks}

        def reset(self, *, seed=None, options=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self._t = 0
            return self._obs(), {}

        def step(self, action):
            a0, a1, a2 = (int(x) for x in np.asarray(action).reshape(-1))
            m = self._masks
            bad = m["mask_action_type"][a0] == 0
            if a0 == N_MOVEMENT_ACTIONS + FN_CRAFT - 1:
                bad |= m["mask_craft_smelt"][a1] == 0
            if a0 in (N_MOVEMENT_ACTIONS + FN_EQUIP - 1, N_MOVEMENT_ACTIONS + FN_PLACE - 1):
                bad |= m["mask_equip_place"][a2] == 0
            if a0 == N_MOVEMENT_ACTIONS + FN_DESTROY - 1:
                bad |= m["mask_destroy"][a2] == 0
            type(self).checked["actions"] += 1
            type(self).checked["excluded"] += int(bad)
            type(self).checked["with_argument"] += int(a0 >= N_MOVEMENT_ACTIONS + FN_CRAFT - 1)
            self._t += 1
            return self._obs(), 0.0, False, self._t >= self._len, {}

    return MaskedDummyEnv


def phase_vecenv_masks(torch, run_root: Path) -> dict:
    """Phase 60 (second half): DV3-XL with ``algo.actor.action_masks=True``
    through ``cli.run`` on a masked multi-discrete dummy env
    (:func:`_masked_env_cls`): over ``MASK_STEPS`` player steps no excluded
    action reaches an env; then the player step of the same agent (weights
    from the seed), captured as the loop captures it, equals the eager step
    bit for bit (carry and action) on fresh masks, and samples nothing
    excluded."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import latent_player_step
    from sheeprl_tpu_torch.algos.ppo.utils import prepare_obs, spaces_to_dims
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.ops import gru, rssm
    from sheeprl_tpu_torch.serve.loader import probe_spaces
    from sheeprl_tpu_torch.utils import env as env_mod

    env_cls = _masked_env_cls()
    env_mod.DUMMY_ENVS["masked_dummy"] = env_cls
    log_dir = run_root / "masked"
    try:
        rssm.LAUNCHES["rssm"] = gru.LAUNCHES["gru"] = 0
        t0 = time.perf_counter()
        run([*MASKED_XL, "checkpoint.save_last=False", f"log_dir={log_dir}"])
        wall = time.perf_counter() - t0
        counts = {"rssm": rssm.LAUNCHES["rssm"], "gru": gru.LAUNCHES["gru"]}
        checked = dict(env_cls.checked)
        # the same agent at fresh weights from the config's seed
        cfg = compose([*(o for o in MASKED_XL if not o.startswith("fabric.accelerator")), DEPLOY_DEVICE])
        fabric = build_fabric(cfg)
        obs_space, act_space = probe_spaces(cfg)
        dims, cont = spaces_to_dims(act_space)
        modules = build_agent(fabric, dims, cont, cfg, obs_space)
    finally:
        env_mod.DUMMY_ENVS.pop("masked_dummy", None)
    wm, actor, dev = modules["world_model"], modules["actor"], fabric.device
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    gens = {k: torch.Generator(dev).manual_seed(13) for k in ("graph", "eager")}

    def stepper(gen):
        def step(carry, obs, greedy: bool = False):
            return latent_player_step(wm, actor, carry, obs, gen, greedy, True)
        return step

    graph = fabric.compile(stepper(gens["graph"]), name="dreamer_v3.player_step", static_argnames=("greedy",),
                           device=dev, generators=(gens["graph"],))
    eager = stepper(gens["eager"])
    envs = [env_cls() for _ in range(4)]
    raw = [e.reset(seed=100 + i)[0] for i, e in enumerate(envs)]
    zero = lambda: (torch.zeros(4, wm.recurrent_size, device=dev), torch.zeros(4, wm.stoch_flat, device=dev),  # noqa: E731
                    torch.zeros(4, sum(dims), device=dev))
    carries = {"graph": zero(), "eager": zero()}
    before = dict(env_cls.checked)
    same = 0
    steps = 12
    with torch.inference_mode():
        for t in range(steps):
            obs = prepare_obs({k: np.stack([r[k] for r in raw]) for k in raw[0]}, (), mlp_keys, dev)
            greedy = t % 3 == 2
            carries["graph"], a_graph = graph(carries["graph"], obs, greedy=greedy)
            carries["eager"], a_eager = eager(carries["eager"], obs, greedy=greedy)
            same += int(torch.equal(a_graph, a_eager) and all(torch.equal(x, y) for x, y in
                                                               zip(carries["graph"], carries["eager"])))
            idx = [a_graph[:, sum(dims[:b]):sum(dims[:b + 1])].argmax(-1).cpu().numpy() for b in range(len(dims))]
            raw = [e.step(np.array([idx[b][i] for b in range(len(dims))]))[0] for i, e in enumerate(envs)]
    replayed = {k: env_cls.checked[k] - before[k] for k in before}
    log(f"[masks] DV3-XL with algo.actor.action_masks through cli.run, {checked['actions']} player actions in a "
        f"{wall:.1f} s run ({checked['with_argument']} with an argument branch): {checked['excluded']} excluded "
        f"actions sampled; rssm launches {counts}; the captured masked player step ({'CUDA graph' if graph.graphs else 'eager'}) "
        f"equals the eager one bit for bit in {same} of {steps} steps, {replayed['excluded']} excluded of "
        f"{replayed['actions']}")
    if (checked["actions"] < MASK_STEPS or checked["excluded"] or not checked["with_argument"] or not graph.graphs
            or same != steps or replayed["excluded"] or counts["rssm"] <= 0 or counts["gru"]):
        raise AssertionError("[masks] an excluded action was sampled, or the captured masked step differs")
    return {"actions": checked["actions"], "excluded": checked["excluded"], "captured_equal": same, "steps": steps,
            "counts": counts, "wall_s": wall}


def vecenv_child(torch, argv) -> int:
    """``--vecenv-child OVERRIDES``: ``cli.run`` with the train windows, the
    replay's tail repairs, the vector env's worker pids and the kernel
    launches logged on lines for phase 61's parent."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer
    from sheeprl_tpu_torch.data.device_replay import DeviceReplay
    from sheeprl_tpu_torch.ops import gru, rssm
    from sheeprl_tpu_torch.utils.env import AsyncVectorEnv, StepDeadlineVectorEnv

    recreate = StepDeadlineVectorEnv._teardown_and_recreate

    def timed_recreate(self, reason):
        t0 = time.perf_counter()
        out = recreate(self, reason)
        log("[child] recreated " + json.dumps({"seconds": time.perf_counter() - t0, "deadline_s": self._deadline}))
        return out

    StepDeadlineVectorEnv._teardown_and_recreate = timed_recreate
    for cls in (EnvIndependentReplayBuffer, DeviceReplay):
        def repair(self, env=0, _orig=cls.repair_tail):
            log(f"[child] repair_tail {env}")
            return _orig(self, env)
        cls.repair_tail = repair
    init = AsyncVectorEnv.__init__
    workers: list = []

    def logged_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        workers[:] = [p.pid for p in self.processes]
        log("[child] workers " + json.dumps(workers))

    AsyncVectorEnv.__init__ = logged_init
    try:
        # each window also names the workers that map the CUDA driver (none may)
        with _window_log(lambda w: log("[child] window " + json.dumps(
                {**w, "cuda_workers": [pid for pid in workers if _maps_cuda(pid)]}))):
            run(list(argv))
    finally:
        log("[child] launches " + json.dumps({"rssm": rssm.LAUNCHES["rssm"], "gru": gru.LAUNCHES["gru"]}))
    return 0


def _vecenv_child(overrides, log_dir: Path, plan: dict = None, new_session: bool = False):
    env = {**os.environ, "SHEEPRL_FAULT_PLAN": json.dumps({"plan": plan})} if plan else None
    return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--vecenv-child", *overrides,
                             f"log_dir={log_dir}"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, start_new_session=new_session)


def _child_lines(out: str, tag: str) -> list:
    return [json.loads(line[len(tag):]) for line in out.splitlines() if line.startswith(tag)]


def start_watchdog_drills(run_root: Path) -> dict:
    """Phase 61's three DreamerV3-S children (``use_pallas``: the GRU
    kernel), started together: a hang planted once past ``learning_starts``;
    a hang at every step with ``max_vecenv_restarts=1``; a run that a SIGTERM
    to its whole process group ends while its workers step, its env 0
    recording episode videos (phase 65)."""
    procs = {
        "hang": _vecenv_child(WATCHDOG_S, run_root / "hang", [
            {"site": "env.step", "kind": "hang", "at": WATCHDOG_HANG_AT, "seconds": 120, "max_fires": 1}]),
        "giveup": _vecenv_child([*WATCHDOG_S, "env.step_deadline_s=3", "env.max_vecenv_restarts=1"],
                                run_root / "giveup", [{"site": "env.step", "kind": "hang", "every": 1,
                                                       "seconds": 120}]),
        "sigterm": _vecenv_child([*(o for o in WATCHDOG_S if not o.startswith(("algo.total_steps", "env.num_envs"))),
                                  "algo.total_steps=1000000", "checkpoint.every=1000000000", *VIDEO_S],
                                 run_root / "sigterm", new_session=True),
    }
    out = {}
    for name, proc in procs.items():
        lines, seen = [], threading.Event()
        marker = _replayed if name == "sigterm" else (lambda line: False)
        out[name] = {"proc": proc, "lines": lines, "seen": seen, "reader": _read_lines(proc, lines, seen, marker),
                     "log_dir": run_root / name}
    sig = out["sigterm"]

    def signal_when_replayed():
        # the SIGTERM lands while the worker steps, after the first replayed window
        if sig["seen"].wait(600) and sig["proc"].poll() is None:
            sig["t_signal"] = time.time()
            os.killpg(sig["proc"].pid, signal.SIGTERM)

    threading.Thread(target=signal_when_replayed, daemon=True).start()
    return out


def phase_watchdog(torch, drills: dict) -> dict:
    """Phase 61: the three drills of :func:`start_watchdog_drills`.  The
    planted hang is torn down, the env recreated and the break flagged
    (``repair_tail``), and the run commits its last step and exits 0; the
    give-up exits non-zero with a ``postmortem.json`` of reason
    ``watchdog``; the SIGTERM to the process group (the workers ignore it)
    ends in a committed save and exit 0, and no worker outlives the run."""
    from sheeprl_tpu_torch.checkpoint.protocol import checkpoint_step, list_checkpoints
    from sheeprl_tpu_torch.utils.env import pid_alive

    def finish(d, timeout=600):
        try:
            d["rc"] = d["proc"].wait(timeout=timeout)
        finally:
            if d["proc"].poll() is None:
                d["proc"].kill()
                d["proc"].wait()
        d["reader"].join(10)
        d["out"] = "".join(d["lines"])
        return d

    def steps(log_dir):
        return sorted(checkpoint_step(d) for root in log_dir.glob("**/version_*/checkpoint")
                      for d in list_checkpoints(root))

    t0 = time.perf_counter()
    res = {name: finish(d) for name, d in drills.items()}
    hang, giveup, sigterm = res["hang"], res["giveup"], res["sigterm"]
    hang_steps, sig_steps = steps(hang["log_dir"]), steps(sigterm["log_dir"])
    repairs = [line for line in hang["out"].splitlines() if line.startswith("[child] repair_tail")]
    gru_launches = {n: (_child_lines(d["out"], "[child] launches ") or [{}])[-1] for n, d in res.items()}
    windows = _windows(hang["out"])
    recreated = _child_lines(hang["out"], "[child] recreated ")
    rec = ", ".join(f"{r['seconds']:.2f}" for r in recreated)
    post = sorted(giveup["log_dir"].glob("**/postmortem.json"))
    doc = json.loads(post[-1].read_text()) if post else {}
    kinds = [e.get("kind") for e in doc.get("events", [])]
    workers = [pid for d in res.values() for pids in _child_lines(d["out"], "[child] workers ") for pid in pids]
    sig_workers = [pid for pids in _child_lines(sigterm["out"], "[child] workers ") for pid in pids]
    orphans = [pid for pid in workers if pid_alive(pid)]
    cuda_workers = sorted({pid for d in res.values() for w in _child_lines(d["out"], "[child] window ")
                           for pid in w["cuda_workers"]})
    video = phase_video(sigterm["log_dir"], sig_steps)
    log(f"[watchdog] DV3-S, hang planted at worker step {WATCHDOG_HANG_AT}: exit {hang['rc']}, "
        f"'vector env watchdog' warned {hang['out'].count('vector env watchdog')}x, the workers killed, recreated "
        f"and reset in {rec} s after the {WATCHDOG_S_DEADLINE} s "
        f"deadline, {len(repairs)} repair_tail "
        f"({', '.join(repairs[:2])}), committed steps {hang_steps}, {len(windows)} windows, launches "
        f"{gru_launches['hang']}")
    log(f"[watchdog] a hang at every step, max_vecenv_restarts=1: exit {giveup['rc']}, postmortem "
        f"{post[-1].name if post else None} reason {doc.get('reason')!r}, events {kinds[-4:]}")
    log(f"[watchdog] SIGTERM to the process group while the worker {sig_workers} stepped: exit {sigterm['rc']}, "
        f"committed {sig_steps}, 'Preemption: committed' {'Preemption: committed checkpoint' in sigterm['out']}; "
        f"workers still alive after the three runs: {orphans} of {workers}; workers mapping the CUDA driver at "
        f"any window: {cuda_workers}")
    ok = (hang["rc"] == 0 and "vector env watchdog" in hang["out"] and recreated and repairs and hang_steps
          and hang_steps[-1] == WATCHDOG_TOTAL and gru_launches["hang"].get("gru", 0) > 0
          and not gru_launches["hang"].get("rssm")
          and giveup["rc"] != 0 and doc.get("reason") == "watchdog" and "watchdog.giveup" in kinds
          and "t_signal" in sigterm and sigterm["rc"] == 0 and "Preemption: committed checkpoint" in sigterm["out"]
          and sig_steps
          and sig_workers and not orphans and not cuda_workers and video["ok"])
    if not ok:
        raise AssertionError("[watchdog] a drill misbehaved:\n" + "\n".join(
            f"--- {n} (rc {d['rc']}):\n{d['out'][-3000:]}" for n, d in res.items()))
    return {"hang_steps": hang_steps, "repairs": len(repairs), "recreate_s": [r["seconds"] for r in recreated],
            "giveup_rc": giveup["rc"],
            "postmortem_reason": doc.get("reason"), "sigterm_steps": sig_steps, "orphans": orphans,
            "cuda_workers": cuda_workers, "video": video,
            "launches": {k: sum(v.get(k, 0) for v in gru_launches.values()) for k in ("rssm", "gru")},
            "seconds": time.perf_counter() - t0}


def phase_video(log_dir: Path, committed: list) -> dict:
    """Phase 65, on phase 61's SIGTERM drill (2 envs in worker processes,
    ``env.capture_video=True``): the videos are env 0's alone, in
    ``{run}/videos``, at gymnasium's capped cubic episodes; each decodes to
    the frames env 0 recorded: one for episode 0 (the build's reset), the
    reset and every step for the rest (:data:`VIDEO_EPISODE_STEPS` steps an
    episode, env 0's steps being the committed policy step over 2 envs),
    at the dummy env's 64 x 64."""
    import cv2

    from sheeprl_tpu_torch.envs.video import capped_cubic_video_schedule

    files = sorted(log_dir.glob("**/*.mp4"))
    dirs = sorted({str(f.parent.relative_to(log_dir)) for f in files})
    steps = committed[-1] // 2 if committed else 0
    want, got = {}, {}
    for e in range(steps // VIDEO_EPISODE_STEPS + 2):
        if capped_cubic_video_schedule(e):
            first = (e - 1) * VIDEO_EPISODE_STEPS  # env 0's steps before episode e
            want[f"rl-video-episode-{e}.mp4"] = 1 if e == 0 else min(VIDEO_EPISODE_STEPS, steps - first) + 1
    want = {k: v for k, v in want.items() if v > 0}
    for f in files:
        cap, n, shape = cv2.VideoCapture(str(f)), 0, None
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            n, shape = n + 1, frame.shape
        cap.release()
        got[f.name] = (n, shape)
    ok = (len(dirs) == 1 and dirs[0].endswith("videos") and {k: v[0] for k, v in got.items()} == want
          and all(v[1] == (64, 64, 3) for v in got.values()))
    log(f"[video] phase 61's SIGTERM drill with env.capture_video: {len(files)} videos in {dirs}, frames "
        f"{ {k: v[0] for k, v in got.items()} } against env 0's recorded steps {want} (committed step "
        f"{committed[-1] if committed else None}, {steps} steps of env 0)")
    return {"ok": ok, "frames": {k: v[0] for k, v in got.items()}, "expected": want, "dirs": dirs}


def _fixture_trainers(torch, device: str, with_opt_state: bool = True):
    """A DreamerV3 trainer on ``device`` (``cpu`` or ``gpu``) from the
    fixture's converted state, as the resumed loop builds it."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_dv3_optimizers
    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.convert import load_resume_state
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.serve.loader import probe_spaces

    cfg = compose([*(o for o in FIXTURE_RESUME if not o.startswith("fabric.accelerator")),
                   f"fabric.accelerator={device}"])
    fabric = build_fabric(cfg)
    state = load_resume_state(FIXTURE_STEP, cfg)
    obs_space, act_space = probe_spaces(cfg)
    dims, cont = spaces_to_dims(act_space)
    modules = build_agent(fabric, dims, cont, cfg, obs_space, state["agent"])
    opts = build_dv3_optimizers(cfg, modules, state["opt_state"] if with_opt_state else None,
                                capturable=fabric.device.type == "cuda")
    return DV3Trainer(cfg, modules, opts, ("rgb",), ("state",), cont, state["agent"]), state


def phase_jax_resume(torch, run_root: Path) -> dict:
    """Phase 62: the committed JAX-written fixture (``fused_pallas``) resumed
    by ``cli.run`` on the card: the counters go on from step 40, update 20,
    and the RSSM kernel launches in every update; the first update from the
    converted state, card against CPU on the same replay block and draws
    (the categorical samples of the CPU run replayed): losses and parameter
    changes within ``RESUME_TOL_*``, and without the Adam state the change
    far outside; then ``checkpoint.resume_from=auto`` continues the port's
    own snapshot."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import blocks_to_device, draw_noise
    from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
    from sheeprl_tpu_torch.ops import rssm
    from sheeprl_tpu_torch.utils.distribution import OneHotCategorical

    t0 = time.perf_counter()
    log_dir = run_root / "jax_resume"
    first = _train(torch, [*FIXTURE_RESUME, f"checkpoint.resume_from={FIXTURE_STEP}", "algo.total_steps=64",
                           "root_dir=fixture", "run_name=resumed"], log_dir, "rssm", FIXTURE_LAUNCHES_PER_UPDATE)
    saved = load_step_dir(first["snapshot"], map_location="cpu")
    resumed_rows = sorted({int(s) for s, _ in _metric_rows_steps(first["snapshot"].parents[1])})

    # the first resumed update, card vs CPU
    L, B, H = 8, 2, 4  # FIXTURE_RESUME's sequence, batch and horizon
    rng = np.random.default_rng(62)
    block = {"rgb": rng.integers(0, 256, (1, L, B, 64, 64, 3), dtype=np.uint8),
             "state": rng.standard_normal((1, L, B, 4)).astype(np.float32),
             "actions": np.eye(4, dtype=np.float32)[rng.integers(0, 4, (1, L, B))],
             "rewards": rng.standard_normal((1, L, B, 1)).astype(np.float32),
             "terminated": (rng.random((1, L, B, 1)) < 0.1).astype(np.float32),
             "is_first": (rng.random((1, L, B, 1)) < 0.1).astype(np.float32)}
    samples, replay = [], {"on": False, "i": 0}
    sample_from_noise = OneHotCategorical.sample_from_noise

    def recorded(self, noise):
        if replay["on"]:
            replay["i"] += 1
            return samples[replay["i"] - 1].to(noise.device)
        out = sample_from_noise(self, noise)
        samples.append(out)
        return out

    def update(device, with_opt_state=True):
        trainer, state = _fixture_trainers(torch, device, with_opt_state)
        start = {n: {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
                 for n, m in trainer.modules().items()}
        noise = draw_noise(trainer.world_model, trainer.actor, 1, L, B, H, torch.Generator("cpu").manual_seed(62),
                           trainer.task_rollout)
        noise = _to_device(noise, trainer.device)
        replay["i"] = 0
        OneHotCategorical.sample_from_noise = recorded
        try:
            metrics = trainer.train_phase(blocks_to_device(block, ("rgb",), ("state",), trainer.device), noise,
                                          int(state["grad_steps"]))
        finally:
            OneHotCategorical.sample_from_noise = sample_from_noise
        replay["on"] = True
        after = {n: {k: v.detach().cpu() for k, v in m.state_dict().items()} for n, m in trainer.modules().items()}
        return np.array([float(m) for m in metrics]), start, after

    cpu_metrics, cpu_start, cpu_after = update("cpu")
    n0 = rssm.LAUNCHES["rssm"]
    card_metrics, _, card_after = update("gpu")
    card_launches = rssm.LAUNCHES["rssm"] - n0
    _, _, control_after = update("gpu", with_opt_state=False)

    def change_gap(after):
        gaps = {}
        for name in ("world_model", "actor", "critic"):
            ref = torch.cat([(cpu_after[name][k] - cpu_start[name][k]).flatten() for k in cpu_after[name]])
            got = torch.cat([(after[name][k] - cpu_start[name][k]).flatten() for k in cpu_after[name]])
            gaps[name] = float((got - ref).norm() / ref.norm())
        return gaps

    loss_gap = np.abs(card_metrics - cpu_metrics)
    loss_rel = float(np.max(loss_gap / np.maximum(np.abs(cpu_metrics), 1e-12)))
    loss_ok = bool(np.all(loss_gap <= RESUME_TOL_LOSS[0] * np.abs(cpu_metrics) + RESUME_TOL_LOSS[1]))
    gaps, control = change_gap(card_after), change_gap(control_after)

    # the port's own snapshot, continued by resume_from=auto
    auto = _train(torch, [*FIXTURE_RESUME, "checkpoint.resume_from=auto", "algo.total_steps=84", "root_dir=fixture",
                          "run_name=resumed"], log_dir, "rssm", FIXTURE_LAUNCHES_PER_UPDATE)
    auto_saved = load_step_dir(auto["snapshot"], map_location="cpu")
    log(f"[jax-resume] the JAX-written fixture resumed by cli.run on the card: rows logged from step "
        f"{resumed_rows[:1]}, committed step {saved['policy_step']} update {saved['update']} grad steps "
        f"{saved['grad_steps']} ({first['updates']} updates, rssm launches per update {sorted(set(first['per_update']))}, "
        f"{first['updates_per_s']:.3f} updates/s); resume_from=auto continued it to step {auto_saved['policy_step']} "
        f"update {auto_saved['update']} ({auto['updates']} updates)")
    log(f"[jax-resume] first resumed update, card vs CPU from the same converted state ({len(samples)} samples "
        f"replayed, {card_launches} rssm launches on the card): losses abs diff "
        f"{', '.join(f'{x:.2e}' for x in loss_gap)} of {', '.join(f'{x:.4g}' for x in cpu_metrics)} (max rel "
        f"{loss_rel:.3g}; tolerance {RESUME_TOL_LOSS[0]} rel + {RESUME_TOL_LOSS[1]} abs), parameter changes rel L2 "
        f"{', '.join(f'{k} {v:.3g}' for k, v in gaps.items())} (tolerance {RESUME_TOL_CHANGE}); without the Adam "
        f"state {', '.join(f'{k} {v:.3g}' for k, v in control.items())}")
    checks = {"counters": (saved["policy_step"], saved["update"]) == (64, 32) and bool(resumed_rows)
              and resumed_rows[0] > 40 and saved["grad_steps"] > 1,
              "auto": (auto_saved["policy_step"], auto_saved["update"]) == (84, 42)
              and auto_saved["grad_steps"] > saved["grad_steps"],
              "launches": card_launches > 0, "losses": loss_ok,
              "changes": max(gaps.values()) <= RESUME_TOL_CHANGE,
              "control": min(control.values()) > 3 * RESUME_TOL_CHANGE}
    if not all(checks.values()):
        raise AssertionError(f"[jax-resume] failed checks: {[k for k, v in checks.items() if not v]}")
    return {"first": first, "auto": auto, "loss_rel": loss_rel, "change_gap": gaps, "control_gap": control,
            "counts": {k: first["counts"][k] + auto["counts"][k] for k in ("rssm", "gru")},
            "card_update_launches": card_launches, "seconds": time.perf_counter() - t0}


# phase 64: the committed JAX-written PPO population (P = 4, Adam;
# tools/write_jax_population_fixture.py) resumed on the card with the tool's
# own recipe
POP_FIXTURE_DIR = ROOT / "tests" / "fixtures" / "jax_ppo_population"

def _pop_fixture_recipe(accelerator: str) -> tuple:
    """The recipe ``tools/write_jax_population_fixture.py`` wrote the fixture
    with, on ``accelerator``, and the env steps of one population phase."""
    from tools.write_jax_population_fixture import NUM_ENVS, POPULATION_OVERRIDES, ROLLOUT, SIZE

    recipe = (*(o for o in POPULATION_OVERRIDES if not o.startswith(("fabric.accelerator", "algo.total_steps"))),
              f"fabric.accelerator={accelerator}")
    return recipe, SIZE * NUM_ENVS * ROLLOUT


# the first resumed phase, card vs CPU from the same converted state and draws:
# the parameter changes within phase 62's 5e-2 relative L2 (Adam's normalised
# step turns one ulp of a gradient into 5e-2 of a change, ROADMAP.md §C);
# without the optimizer state the change must miss that by 5x at least
POP_RESUME_TOL, POP_RESUME_CONTROL = 5e-2, 5


def phase_population_resume(torch, run_root: Path) -> dict:
    """Phase 64: the committed JAX population resumed by ``cli.run`` on the
    card for two population phases: the counters, the exploits (one more at
    ``exploit_every=2``) and every member's episodes go on from the
    snapshot; then the first resumed phase from the converted state on the
    card and on the CPU with the same draws (action noise, resets, minibatch
    orders, explore factors): the parameter changes within
    ``POP_RESUME_TOL``, and without the optimizer state far outside."""
    from sheeprl_tpu_torch.algos.ppo.agent import action_noise
    from sheeprl_tpu_torch.algos.ppo.population import PopulationRoute
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer
    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.convert import load_resume_state
    from sheeprl_tpu_torch.envs.device import env_from_cfg
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.ops import gru, rssm
    from sheeprl_tpu_torch.population import perturbation_factors
    from sheeprl_tpu_torch.population.members import member_permutations

    t0 = time.perf_counter()
    card_accel = "cpu" if CARD == "cpu" else "gpu"
    recipe, phase_steps = _pop_fixture_recipe(card_accel)
    (step,) = (POP_FIXTURE_DIR / "checkpoint").glob("step_*")
    saved = load_step_dir(step)
    carry = saved["population"]
    total = int(saved["policy_step"]) + 2 * phase_steps
    log_dir = run_root / "population_resume"
    before = (rssm.LAUNCHES["rssm"], gru.LAUNCHES["gru"])
    run([*recipe, f"checkpoint.resume_from={step}", f"algo.total_steps={total}", f"log_dir={log_dir}"])
    counts = {"rssm": rssm.LAUNCHES["rssm"] - before[0], "gru": gru.LAUNCHES["gru"] - before[1]}
    (last,) = sorted(log_dir.glob("**/checkpoint/step_*"))[-1:]
    resumed = load_step_dir(last, map_location="cpu")
    pop = resumed["population"]

    def route(accelerator: str, with_opt_state: bool = True):
        cfg = compose([*_pop_fixture_recipe(accelerator)[0], f"checkpoint.resume_from={step}"])
        fabric = build_fabric(cfg)
        state = load_resume_state(step, cfg)
        if not with_opt_state:
            state.pop("opt_state")
        env = env_from_cfg(cfg)
        dims, cont = spaces_to_dims(env.action_space)
        gens = {k: torch.Generator(fabric.device).manual_seed(i) for i, k in enumerate(("train", "player", "env"))}
        return PopulationRoute(fabric, cfg, PPOTrainer, env, env.observation_space, env.action_space, dims, cont,
                               gens, state, int(state["update"]) + 1), dims, cont

    cpu, dims, cont = route("cpu")
    P, B, T = cpu.size, cpu.num_envs, cpu.trainer.T
    single = cpu.trainer.single
    gen = torch.Generator().manual_seed(64)
    rows = torch.zeros(P * B, sum(dims))
    draws = {"members": {
        "noise": [action_noise(rows, dims, cont, "auto", gen) for _ in range(T)],
        "reset": [cpu.venv.env.draw_reset(P * B, gen, torch.device("cpu")) for _ in range(T)],
        "perms": torch.stack([member_permutations(gen, P, T * B, single.num_minibatches * single.batch_size)
                              for _ in range(single.update_epochs)], dim=1)},
        "factors": perturbation_factors(cpu.pbt, sorted(cpu.hp), gen)}
    start = {k: v.detach().clone() for k, v in cpu.agent.state_dict().items()}
    env0 = [t.clone() for t in cpu.pop["members"]["env"]]
    cpu_losses, _ = cpu.step._fn(draws)
    ref = {k: v.detach() for k, v in cpu.agent.state_dict().items()}

    def card_phase(with_opt_state: bool) -> dict:
        card, _, _ = route(card_accel, with_opt_state)
        with torch.no_grad():
            for dst, src in zip(card.pop["members"]["env"], env0):
                dst.copy_(src)
        losses, _ = card.step._fn(_to(draws, CARD))
        params = {k: v.detach().cpu() for k, v in card.agent.state_dict().items()}
        return change_diffs(torch, start, params, losses.cpu().numpy().reshape(-1), ref,
                            cpu_losses.numpy().reshape(-1))

    got, control = card_phase(True), card_phase(False)
    log(f"[population-resume] the JAX-written PPO population (P = {P}) resumed by cli.run on the card: update "
        f"{saved['update']} -> {resumed['update']}, policy step {saved['policy_step']} -> {resumed['policy_step']}, "
        f"exploits {int(carry['exploits'])} -> {int(pop['exploits'])}, episodes per member "
        f"{np.asarray(carry['ep_count']).tolist()} -> {pop['ep_count'].tolist()}, fitness "
        f"{', '.join(f'{x:.2f}' for x in pop['fitness'].tolist())}; launches {counts}")
    log(f"[population-resume] the first resumed phase card vs CPU (Adam, {P} x {B} envs x {T} steps): "
        f"{show_diffs(got)}; without the optimizer state parameter changes rel L2 diff {control['param_l2']:.3g} "
        f"(tolerance {POP_RESUME_TOL}, the control at least {POP_RESUME_CONTROL}x that); "
        f"{time.perf_counter() - t0:.1f} s")
    checks = {"counters": (resumed["policy_step"], resumed["update"]) == (total, saved["update"] + 2),
              "exploits": int(pop["exploits"]) == int(carry["exploits"]) + 1,
              "episodes": bool((pop["ep_count"].numpy() >= np.asarray(carry["ep_count"])).all()),
              "fitness": bool(torch.isfinite(pop["fitness"]).all()), "launches": counts == {"rssm": 0, "gru": 0},
              "changes": got["param_l2"] <= POP_RESUME_TOL,
              "control": control["param_l2"] >= POP_RESUME_CONTROL * POP_RESUME_TOL}
    if not all(checks.values()):
        raise AssertionError(f"[population-resume] failed checks: {[k for k, v in checks.items() if not v]}")
    return {"update": int(resumed["update"]), "exploits": int(pop["exploits"]), "param_l2": got["param_l2"],
            "loss_rel": got["loss_rel"], "control_l2": control["param_l2"], "counts": counts,
            "seconds": time.perf_counter() - t0}


def _metric_rows_steps(log_dir: Path) -> list:
    import csv

    with open(next(log_dir.glob("**/metrics.csv"))) as f:
        return [(step, name) for step, name, _ in list(csv.reader(f))[1:]]


def phase_vecenv(torch, run_root: Path, breaker=None, supervisor: bool = True, preempt: bool = True,
                 meanwhile_too=None) -> dict:
    """Phases 60-62, with the whole run's other child-process drills: 60's
    two XL runs alone (they are timed); then phase 61's children and phase
    59's supervised runs (its breaker drill started with phase 57) in the
    background while this thread runs phase 49 (``preempt``), and phase 60's
    masked run and phase 62 while 49's child starts, then ``meanwhile_too()``
    (the whole run's correctness checks that time nothing)."""
    t0 = time.perf_counter()
    out = {"xl": phase_vecenv_xl(torch, run_root / "vecenv")}
    drills = start_watchdog_drills(run_root / "watchdog")
    sup, sup_thread = {}, None
    if supervisor:
        sup_thread = threading.Thread(target=lambda: sup.update(_run_catching(
            phase_supervisor, torch, run_root / "supervisor", breaker)))
        sup_thread.start()

    def meanwhile():
        out["masks"] = phase_vecenv_masks(torch, run_root / "vecenv")
        out["jax_resume"] = phase_jax_resume(torch, run_root)
        out["population_resume"] = phase_population_resume(torch, run_root)
        if meanwhile_too is not None:
            meanwhile_too()

    try:
        if preempt:
            out["preempt"] = phase_runtime_preempt(torch, run_root / "runtime", meanwhile=meanwhile)
        else:
            meanwhile()
        out["watchdog"] = phase_watchdog(torch, drills)
    finally:
        for d in drills.values():
            if d["proc"].poll() is None:
                d["proc"].kill()
                d["proc"].wait()
        if sup_thread is not None:
            sup_thread.join()
    if supervisor:
        if "error" in sup:
            raise sup["error"]
        out["supervisor"] = sup["value"]
    out["seconds"] = time.perf_counter() - t0
    log(f"[vecenv] phases 60-62 and 64{' with 49 and 59' if supervisor and preempt else ''} in "
        f"{out['seconds']:.1f} s")
    return out


def _run_catching(fn, *args) -> dict:
    try:
        return {"value": fn(*args)}
    except BaseException as e:  # noqa: BLE001 - raised again in the main thread
        return {"error": e}


def vecenv_summary(v: dict) -> dict:
    return {"updates_per_s": {t: r["updates_per_s"] for t, r in v["xl"]["runs"].items()},
            "env_steps_per_s": {t: r["env_steps_per_s"] for t, r in v["xl"]["runs"].items()},
            "env_step_ms": {t: r["env_step_ms"] for t, r in v["xl"]["runs"].items()},
            "build_s": {t: r["build_s"] for t, r in v["xl"]["runs"].items()},
            "bit_for_bit": [v["xl"]["bit_for_bit"], v["xl"]["tensors"]], "masked_actions": v["masks"]["actions"],
            "excluded": v["masks"]["excluded"], "watchdog": {k: w for k, w in v["watchdog"].items()},
            "jax_resume": {k: v["jax_resume"][k] for k in ("loss_rel", "change_gap", "control_gap")},
            "population_resume": {k: v["population_resume"][k] for k in ("param_l2", "control_l2", "exploits")},
            "seconds": v["seconds"]}


def vecenv_only(torch) -> int:
    """``--vecenv``: phases 60-61 alone (62 and 64 beside 61, 65 in it, as in the whole run)."""
    return _mode_only(torch, lambda run_root: phase_vecenv(torch, run_root, supervisor=False, preempt=False))


def jax_resume_only(torch) -> int:
    """``--jax-resume``: phases 62 and 64 alone."""
    return _mode_only(torch, lambda run_root: {"jax_resume": phase_jax_resume(torch, run_root),
                                                "population_resume": phase_population_resume(torch, run_root)})


def _mode_only(torch, fn) -> int:
    run_root = ROOT / "build" / "chip_smoke_mode"
    shutil.rmtree(run_root, ignore_errors=True)
    log_phase_seconds()
    try:
        device = phase_device(torch)
        phase_build()
        worst = phase_kernels(torch)
        out = fn(run_root)
        log("[mode] " + json.dumps({k: v.get("seconds") for k, v in out.items() if isinstance(v, dict)},
                                   default=float))
        log(f"[mode] kernels held against their plain versions, worst {worst}")
    except BaseException:
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


def population_only(torch) -> int:
    """``--population``: phases 57-59 alone (phase 59 builds the GRU kernel
    its children launch)."""
    log_phase_seconds()
    run_root = ROOT / "build" / "chip_smoke_population"
    shutil.rmtree(run_root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        device = phase_device(torch)
        phase_build()
        population = phase_population(torch, run_root)
        log("[population] " + json.dumps(population_summary(population), default=float))
        log(f"[population] total {time.perf_counter() - t0:.1f} s")
    except BaseException:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


def deploy_only(torch) -> int:
    """``--deploy``: phases 54-56 alone, beside what they read of earlier
    phases: phase 4's served snapshot and phase 51's untraced DV3-XL
    ``cli.run`` twin, whose snapshot also stands for phase 7's."""
    log_phase_seconds()
    run_root = ROOT / "build" / "chip_smoke_deploy"
    shutil.rmtree(run_root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        device = phase_device(torch)
        phase_build()
        served_dir = run_root / "fused_pallas"
        _build_snapshot(torch, [*XL_SERVE, FUSED], served_dir)
        twin = _telemetry_run(torch, (*TELEMETRY_XL, *registry_overrides(run_root / "registry_run")),
                              run_root / "untraced", traced=False)
        twin["registry_root"] = run_root / "registry_run"
        deploy = phase_deploy(torch, run_root, twin["snapshot"], twin, served_dir)
        log("[deploy] " + json.dumps(deploy_summary(deploy), default=float))
        log(f"[deploy] total {time.perf_counter() - t0:.1f} s")
    except BaseException:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


def telemetry_only(torch) -> int:
    """``--telemetry``: phases 51-53 alone, beside what they read of earlier
    phases: phase 4's served snapshot, a short SAC run (phase 20's recipe,
    40 updates), phase 38's XL window (light) and phase 49's preempted
    DV3-XL child."""
    log_phase_seconds()
    run_root = ROOT / "build" / "chip_smoke_telemetry"
    shutil.rmtree(run_root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        device = phase_device(torch)
        phase_build()
        served_dir = run_root / "fused_pallas"
        _build_snapshot(torch, [*XL_SERVE, FUSED], served_dir)
        from sheeprl_tpu_torch.algos.sac.sac import SACTrainer

        sac = _train_off_policy(torch, (*SAC_STATE[:-1], "algo.total_steps=140", "algo.run_test=False"),
                                run_root / "sac", SACTrainer)
        xl = phase_graph_window(torch, "graphs-dv3-xl", [*XL_TRAIN, FUSED], "rssm", light=True, keep=True)
        try:
            spans = phase_telemetry_spans(torch, sac, xl["built"])
        finally:
            _release(torch, xl)
        first, saved_dir = _preempted_xl(torch, run_root / "preempt")
        telemetry = phase_telemetry(torch, run_root, served_dir, spans, {"first": first, "saved_dir": saved_dir})
        log("[telemetry] " + json.dumps(telemetry_summary(telemetry), default=float))
        log(f"[telemetry] total {time.perf_counter() - t0:.1f} s")
    except BaseException:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


def precision_only(torch) -> int:
    """``--precision``: phases 42-47 alone, beside 32-true runs of phase 7's
    and phase 11's recipes and light 32-true windows of phases 38-39."""
    from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import P2EDV3Trainer

    run_root = ROOT / "build" / "chip_smoke_precision"
    shutil.rmtree(run_root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        device = phase_device(torch)
        phase_build()
        fp32 = {"train": _train(torch, [*XL_TRAIN, *XL_TRAIN_STEPS, FUSED, HOST_RING], run_root / "train_xl", "rssm"),
                "p2e": _train(torch, P2E_XL, run_root / "p2e_explore", "rssm", P2E_LAUNCHES_PER_UPDATE,
                              trainer_cls=P2EDV3Trainer)}
        precision = phase_precision(torch, run_root, fp32)
        log("[precision] " + json.dumps(precision_summary(precision), default=float))
        log(f"[precision] total {time.perf_counter() - t0:.1f} s")
    except BaseException:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


def timing_only(torch, package_root: str) -> int:
    """``--timing ROOT``: build and time the kernels of the port found under
    ``ROOT`` (for example an unpacked older commit) at every timed batch,
    with no other phase; the rows go to ``chiprun_out/timing-<dir name>.json``."""
    phase_device(torch)
    phase_build()
    timing = time_kernels(torch, ZAS[0], TIMED_BATCHES)
    out = ROOT / "chiprun_out" / f"timing-{Path(package_root).resolve().name}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(timing, indent=1))
    log(f"[timing] rows written to {out}")
    return 0


# phase 7's XL recipe and phase 20's SAC recipe, each with the health guard on
# and off (``--health-ab ROOT``)
GUARD_AB = {
    "dv3_xl": (*XL_TRAIN, *XL_TRAIN_STEPS, FUSED, HOST_RING, "algo.run_test=False"),
    "sac": (*SAC_STATE, "algo.run_test=False"),
}


def _guard_ab_run(torch, overrides, log_dir: Path) -> dict:
    """One run through ``cli.run``: each call of the loop's train window
    (``<algo>.train_phase[_device]``) timed with the device synchronised
    around it, and, where the package has them, the health guard's host
    steps outside the window (``snapshot`` of the trained state before a
    chunk, ``HealthSentinel.check`` after it) timed the same way.  Returns
    the updates, the window's median ms per update over
    the calls that reused a built entry, the guard's host ms per update, and
    the peak memory."""
    import sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 as dv3
    import sheeprl_tpu_torch.algos.sac.sac as sac
    import sheeprl_tpu_torch.resilience.health as health
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.parallel.compile import GraphFunction

    windows, guard = [], []
    call = GraphFunction.__call__

    def timed_call(self, *args, **kwargs):
        if not self.name.endswith(WINDOW_NAMES):
            return call(self, *args, **kwargs)
        U = args[0] if isinstance(args[0], int) else int(args[0]["rewards"].shape[0])
        entries = self.cache_size()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(self, *args, **kwargs)
        torch.cuda.synchronize()
        windows.append((U, time.perf_counter() - t0, self.cache_size() > entries))
        return out

    def timed(fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            guard.append(time.perf_counter() - t0)
            return out
        return wrapper

    patches = [(GraphFunction, "__call__", timed_call)]
    for owner, name in ((dv3.DreamerTrainer, "snapshot"), (sac.SACTrainer, "snapshot"),
                        (health.HealthSentinel, "check")):
        if hasattr(owner, name):
            patches.append((owner, name, timed(getattr(owner, name))))
    saved = [(owner, name, owner.__dict__[name]) for owner, name, _ in patches]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for owner, name, fn in patches:
        setattr(owner, name, fn)
    try:
        run([*overrides, f"log_dir={log_dir}"])
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    torch.cuda.synchronize()
    updates = sum(u for u, _, _ in windows)
    # steady: the calls that reused an entry (a signature's first call runs
    # eagerly and, on the card, captures its graph)
    steady = [s / u for u, s, built in windows if not built] or [s / u for u, s, _ in windows]
    return {"updates": updates, "windows": len(windows), "window_ms_per_update": 1e3 * statistics.median(steady),
            "guard_host_calls": len(guard), "guard_ms_per_update": 1e3 * sum(guard) / max(updates, 1),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def health_ab(torch, package_root: str) -> int:
    """``--health-ab ROOT``: phase 7's XL recipe (fused RSSM kernel, host
    ring) and phase 20's SAC recipe with the port found under ``ROOT``, each
    run with ``health.enabled`` True and False in turns (on, off, off, on):
    the window's ms per update, the guard's host ms per update outside the
    window, and the peak memory of each run; the rows go to
    ``chiprun_out/health-ab-<dir name>.json``."""
    phase_device(torch)
    phase_build()
    rows = {}
    run_root = ROOT / "build" / "health_ab"
    shutil.rmtree(run_root, ignore_errors=True)
    try:
        for recipe, overrides in GUARD_AB.items():
            for i, on in enumerate((True, False, False, True)):
                r = _guard_ab_run(torch, [*overrides, f"health.enabled={on}"], run_root / f"{recipe}_{i}")
                rows.setdefault(recipe, []).append({"health": on, **r})
                log(f"[health-ab] {recipe} health {'on ' if on else 'off'}: {r['updates']} updates in "
                    f"{r['windows']} windows, window {r['window_ms_per_update']:.3f} ms/update, guard outside "
                    f"the window {r['guard_ms_per_update']:.3f} ms/update ({r['guard_host_calls']} host calls), "
                    f"peak {r['peak_bytes'] / 2**30:.3f} GiB")
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    out = ROOT / "chiprun_out" / f"health-ab-{Path(package_root).resolve().name}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    log(f"[health-ab] rows written to {out}")
    return 0


def first_window(torch) -> int:
    """``--first-window``: the first Ratio window of the default XL recipe
    (``learning_starts=1024``, replay ratio 1: 1024 updates in one window)
    through ``cli.run``, with its chunks, per-update times and peak device
    memory; one JSON line of them goes last."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import window_chunks

    device = phase_device(torch)
    phase_build()
    per_update = (64 * 64 * 3 + 4 * 4 + 4 * (4 + 3)) * 64 * 16  # rgb, state, actions, 3 scalars; L 64, B 16
    chunks = window_chunks(1024, per_update)
    log(f"[first-window] one update's block {per_update} bytes; chunks {chunks}")
    run_root = ROOT / "build" / "chip_smoke_first_window"
    shutil.rmtree(run_root, ignore_errors=True)
    try:
        train = _train(torch, [*XL_TRAIN, FUSED, HOST_RING, "algo.learning_starts=1024", "algo.replay_ratio=1",
                               "algo.total_steps=1024", "algo.run_test=False"], run_root, "rssm")
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    if train["updates"] != 1024:
        raise AssertionError(f"the first window ran {train['updates']} updates, expected 1024")
    print(json.dumps({"first_window": {k: train[k] for k in ("updates", "first_update_s", "median_update_s",
                                                              "updates_per_s", "peak_bytes", "wall_s")},
                      "chunks": chunks, "device": device}), flush=True)
    return 0


def on_policy_only(torch) -> int:
    """``--on-policy``: phases 16-19 alone; one JSON line of their numbers goes last."""
    device = phase_device(torch)
    run_root = ROOT / "build" / "chip_smoke_on_policy"
    shutil.rmtree(run_root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        ppo = phase_ppo_train(torch, run_root / "ppo_atari")
        parity = phase_ppo_parity(torch, ppo["snapshot"])
        served = phase_ppo_serve(torch, ppo["snapshot"])
        family = phase_on_policy_family(torch, run_root / "on_policy")
        log(f"[on-policy] phases 16-19 in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    keep = ("iterations_per_s", "first_iteration_s", "iteration_s", "update_s", "peak_bytes")
    print(json.dumps({
        "ppo": {**{k: ppo[k] for k in (*keep, "env_steps_per_s", "update_device_ms", "update_launches",
                                       "rollout_step_ms")},
                "parity": {k: parity[k] for k in ("param_l2", "loss_rel", "wrong_pad", "tf32", "adam")},
                "serve": {k: served["stats"][k] for k in ("served", "p50_ms", "p99_ms", "rungs")}},
        **{name: {k: run_[k] for k in keep} for name, run_ in family.items()},
        "device": device}), flush=True)
    return 0


def off_policy_only(torch) -> int:
    """``--off-policy``: phases 20-24 alone; one JSON line of their numbers goes last."""
    device = phase_device(torch)
    run_root = ROOT / "build" / "chip_smoke_off_policy"
    shutil.rmtree(run_root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        off = phase_off_policy(torch, run_root)
        log(f"[off-policy] phases 20-24 in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    keep = ("updates", "updates_per_s", "env_steps_per_s", "first_update_s", "peak_bytes", "update_device_ms",
            "update_wall_ms", "update_launches")
    print(json.dumps({
        **{name: {k: run_[k] for k in keep} for name, run_ in off["train"].items()},
        "parity": {name: {k: p[k] for k in ("param_l2", "loss_rel", "control", "tf32", "adam")}
                   for name, p in off["parity"].items()},
        "sac_serve": {k: off["serve"]["stats"][k] for k in ("served", "p50_ms", "p99_ms", "rungs")},
        "device": device}), flush=True)
    return 0


def envs_only(torch) -> int:
    """``--envs``: phases 25-30 alone; one JSON line of their numbers goes last."""
    device = phase_device(torch)
    phase_build()
    run_root = ROOT / "build" / "chip_smoke_envs"
    shutil.rmtree(run_root, ignore_errors=True)
    try:
        envs = phase_envs(torch, run_root)
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    print(json.dumps({**envs_summary(envs), "device": device}, default=float), flush=True)
    return 0


def replay_only(torch) -> int:
    """``--replay``: phases 31-36 alone, beside host-ring runs of phase 7's
    and phases 20-22's recipes; one JSON line of their numbers goes last."""
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainer
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAETrainer

    device = phase_device(torch)
    phase_build()
    run_root = ROOT / "build" / "chip_smoke_replay"
    shutil.rmtree(run_root, ignore_errors=True)
    try:
        host_dv3 = _train(torch, [*XL_TRAIN, *XL_TRAIN_STEPS, FUSED, HOST_RING], run_root / "train_xl", "rssm")
        host_off = {}
        for name, overrides, trainer_cls in (("sac", SAC_STATE, SACTrainer), ("droq", DROQ_STATE, SACTrainer),
                                             ("sac_ae", SAC_AE_RGB, SACAETrainer)):
            host_off[name] = _train_off_policy(torch, overrides, run_root / f"{name}_train", trainer_cls)
            host_off[name].pop("trainer", None)
            host_off[name].pop("batches", None)
        replay = phase_replay(torch, run_root / "replay", host_dv3, host_off)
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    print(json.dumps({**replay_summary(replay), "host_dv3_updates_per_s": host_dv3["updates_per_s_events"],
                      "host_off_policy_updates_per_s": {n: r["updates_per_s_events"] for n, r in host_off.items()},
                      "device": device}, default=float), flush=True)
    return 0


# ``--replay-ab``: the ring's place in turns on one card (host, card, card,
# host), every run timed alike (CUDA events alone, nothing synchronised around
# an update): phase 7's XL recipe (a 4,096-step ring, no spill) and phases 20
# and 22's SAC and SAC-AE
REPLAY_AB = {
    "dv3_xl": ((*XL_TRAIN, *XL_TRAIN_STEPS, FUSED), "rssm"),
    "sac": (tuple(o for o in SAC_STATE if o != HOST_RING), None),
    "sac_ae": (tuple(o for o in SAC_AE_RGB if o != HOST_RING), None),
}


def replay_ab(torch) -> int:
    """``--replay-ab``: the host ring against the card's ring, in turns, for
    the recipes of ``REPLAY_AB``; updates/s (per update, CUDA events), env
    steps/s (off-policy: one env step and its window) and each run's wall
    seconds.  One JSON line of them goes last."""
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainer
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAETrainer

    device = phase_device(torch)
    phase_build()
    run_root = ROOT / "build" / "chip_smoke_replay_ab"
    shutil.rmtree(run_root, ignore_errors=True)
    trainers = {"sac": SACTrainer, "sac_ae": SACAETrainer}
    rows = {}
    try:
        for name, (overrides, kernel) in REPLAY_AB.items():
            for turn, ring in enumerate(("host", "card", "card", "host")):
                ov, log_dir = (*overrides, f"buffer.device={ring == 'card'}"), run_root / f"{name}_{turn}_{ring}"
                if name in trainers:
                    r = _train_off_policy(torch, ov, log_dir, trainers[name], events_only=True)
                else:
                    r = _train(torch, ov, log_dir, kernel, events_only=True)
                row = {"ring": ring, "updates_per_s": r["updates_per_s"], "wall_s": r["wall_s"],
                       "env_steps_per_s": r.get("env_steps_per_s")}
                rows.setdefault(name, []).append(row)
                log(f"[replay-ab] {name}, turn {turn + 1}, the {ring} ring: {row['updates_per_s']:.3f} updates/s"
                    + (f", {row['env_steps_per_s']:.1f} env steps/s" if row["env_steps_per_s"] else "")
                    + f", the run {row['wall_s']:.1f} s")
                shutil.rmtree(log_dir, ignore_errors=True)
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    print(json.dumps({"replay_ab": rows, "device": device}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; it runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] in (["--timing"], ["--health-ab"]):
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
    try:
        import sheeprl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke.py: run it from the root of a sheeprl-tpu checkout ({e})", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--timing"]:
        log(f"[timing] sheeprl_tpu_torch from {Path(sheeprl_tpu_torch.__file__).parent}")
        return timing_only(torch, sys.argv[2])
    if sys.argv[1:2] == ["--preempt-child"]:
        return preempt_child(torch, sys.argv[2:])
    if sys.argv[1:2] == ["--commit-hang-child"]:
        return commit_hang_child(torch, sys.argv[2])
    if sys.argv[1:2] == ["--runtime"]:
        return runtime_only(torch)
    if sys.argv[1:2] == ["--health-ab"]:
        log(f"[health-ab] sheeprl_tpu_torch from {Path(sheeprl_tpu_torch.__file__).parent}")
        return health_ab(torch, sys.argv[2])
    if sys.argv[1:2] == ["--first-window"]:
        return first_window(torch)
    if sys.argv[1:2] == ["--on-policy"]:
        return on_policy_only(torch)
    if sys.argv[1:2] == ["--off-policy"]:
        return off_policy_only(torch)
    if sys.argv[1:2] == ["--envs"]:
        return envs_only(torch)
    if sys.argv[1:2] == ["--replay"]:
        return replay_only(torch)
    if sys.argv[1:2] == ["--replay-ab"]:
        return replay_ab(torch)
    if sys.argv[1:2] == ["--graphs"]:
        return graphs_only(torch)
    if sys.argv[1:2] == ["--matmul-precision"]:
        return matmul_precision_only(torch)
    if sys.argv[1:2] == ["--scale"]:
        return scale_only(torch)
    if sys.argv[1:2] == ["--sebulba"]:
        return _mode_only(torch, lambda run_root: phase_sebulba(torch, run_root))
    if sys.argv[1:2] == ["--precision"]:
        return precision_only(torch)
    if sys.argv[1:2] == ["--telemetry"]:
        return telemetry_only(torch)
    if sys.argv[1:2] == ["--deploy"]:
        return deploy_only(torch)
    if sys.argv[1:2] == ["--population"]:
        return population_only(torch)
    if sys.argv[1:2] == ["--supervised-child"]:
        return supervised_child(torch, sys.argv[2:])
    if sys.argv[1:2] == ["--vecenv-child"]:
        return vecenv_child(torch, sys.argv[2:])
    if sys.argv[1:2] == ["--vecenv"]:
        return vecenv_only(torch)
    if sys.argv[1:2] == ["--jax-resume"]:
        return jax_resume_only(torch)

    run_root = ROOT / "build" / "chip_smoke"
    shutil.rmtree(run_root, ignore_errors=True)
    log_phase_seconds()
    # the envs' worker server (phase 60) starts now, beside the earlier phases
    from sheeprl_tpu_torch.utils.env import worker_context

    worker_context()
    try:
        t_start = time.perf_counter()
        device = phase_device(torch)
        # the kernels' nvcc builds run while the two served snapshots are built
        # (which launch no kernel)
        build = threading.Thread(target=lambda: built.update(_run_catching(phase_build)))
        built = {}
        build.start()
        fused_dir, gru_dir = run_root / "fused_pallas", run_root / "use_pallas"
        try:
            _build_snapshot(torch, [*XL_SERVE, "algo.world_model.recurrent_model.fused_pallas=True"], fused_dir)
            _build_snapshot(torch, [*XL_SERVE, "algo.world_model.recurrent_model.use_pallas=True"], gru_dir)
        finally:
            build.join()
        if "error" in built:
            raise built["error"]
        worst = phase_kernels(torch)

        served = _drive(torch, fused_dir, SERVE_SESSIONS, SERVE_STEPS)
        if served["counts"]["rssm"] < served["stats"]["batches"] or served["counts"]["gru"]:
            raise AssertionError(f"rssm launches {served['counts']} vs {served['stats']['batches']} batches")
        parity_err = phase_parity(torch, served["service"], main_rung(served["stats"]))
        za = served["service"].player.params["world_model"].recurrent_model.in_kernel.shape[0]
        del served["service"]
        torch.cuda.empty_cache()

        gru_served = _drive(torch, gru_dir, 1, SERVE_STEPS)
        if gru_served["counts"]["gru"] < gru_served["stats"]["batches"] or gru_served["counts"]["rssm"]:
            raise AssertionError(f"gru launches {gru_served['counts']} vs {gru_served['stats']['batches']} batches")
        del gru_served["service"]

        rung = {"rssm": main_rung(served["stats"]), "gru": main_rung(gru_served["stats"])}
        timing = time_kernels(torch, za, sorted({*TIMED_BATCHES, *rung.values()}))
        train = _train(torch, [*XL_TRAIN, *XL_TRAIN_STEPS, FUSED, HOST_RING], run_root / "train_xl", "rssm")
        if train["counts"]["gru"]:
            raise AssertionError(f"the fused-RSSM training run launched the gru kernel: {train['counts']}")
        train_parity = phase_train_parity(torch, train["snapshot"])
        phase_serve_trained(torch, train["snapshot"])
        train_gru = _train(torch, S_TRAIN, run_root / "train_s_gru", "gru")
        if train_gru["counts"]["rssm"]:
            raise AssertionError(f"the use_pallas training run launched the rssm kernel: {train_gru['counts']}")

        from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import P2EDV3Trainer

        p2e = _train(torch, P2E_XL, run_root / "p2e_explore", "rssm", P2E_LAUNCHES_PER_UPDATE,
                     trainer_cls=P2EDV3Trainer)
        if p2e["counts"]["gru"] or len(p2e["intrinsic"]) != p2e["updates"]:
            raise AssertionError(f"P2E exploration: launches {p2e['counts']}, intrinsic rewards {p2e['intrinsic']}")
        p2e_parity = phase_train_parity(torch, p2e["snapshot"], tag="p2e-parity")
        finetune = phase_p2e_finetune(torch, p2e["snapshot"], run_root / "p2e_finetune")
        decoupled = _train(torch, DECOUPLED_XL, run_root / "decoupled", "rssm", snapshot=False)
        decoupled.pop("trainer")
        family = phase_family(torch, run_root / "family")
        ppo = phase_ppo_train(torch, run_root / "ppo_atari")
        ppo_served = phase_ppo_serve(torch, ppo["snapshot"])
        on_policy = phase_on_policy_family(torch, run_root / "on_policy")
        off_policy = phase_off_policy(torch, run_root / "off_policy")
        decoupled_algos = phase_decoupled(torch, run_root / "decoupled")
        envs = phase_envs(torch, run_root / "envs", parity=False)
        sebulba = phase_sebulba(torch, run_root / "sebulba", decoupled_algos,
                                envs["ppo"]["anakin"]["env_steps_per_s"])
        replay = phase_replay(torch, run_root / "replay", train, off_policy["train"])
        log("[replay] " + json.dumps(replay_summary(replay), default=float))
        graphs = phase_graphs(torch, run_root / "graphs", served, fused_dir, envs["ppo"]["anakin"],
                              off_policy["train"]["sac"]["kept"])
        log("[graphs] " + json.dumps(graphs_summary(graphs), default=float))
        precision = phase_precision(torch, run_root / "precision", {"train": train, "p2e": p2e,
                                                                     "dv3_xl": graphs["dv3_xl"],
                                                                     "dv3_s_gru": graphs["dv3_s_gru"],
                                                                     "bf16": graphs.pop("bf16")},
                                    families=False)
        runtime = phase_runtime(torch, run_root / "runtime", fused_dir, preempt=False)
        telemetry = phase_telemetry(torch, run_root, fused_dir, graphs["spans"])
        deploy = phase_deploy(torch, run_root, train["snapshot"], telemetry["traced"]["untraced"], fused_dir)
        log("[deploy] " + json.dumps(deploy_summary(deploy), default=float))
        population = phase_population(torch, run_root / "population", supervisor=False)
        breaker = population.pop("breaker")
        deferred = {}

        def correctness_checks():
            # phases 17, 25 and 47 compare and time nothing, and change no
            # setting a child process inherits: they run while phase 49's
            # child starts (phase_vecenv)
            deferred["ppo_parity"] = phase_ppo_parity(torch, ppo["snapshot"])
            precision["families"] = phase_precision_families(torch)
            envs["parity"] = phase_env_parity(torch)

        try:
            vecenv = phase_vecenv(torch, run_root, breaker=breaker, meanwhile_too=correctness_checks)
        finally:
            if breaker[0].poll() is None:
                breaker[0].kill()
                breaker[0].wait()
        population["supervisor"] = vecenv.pop("supervisor")
        ppo_parity = deferred["ppo_parity"]
        log("[envs] " + json.dumps(envs_summary(envs), default=float))
        log("[precision] " + json.dumps(precision_summary(precision), default=float))
        runtime["preempt"] = vecenv.pop("preempt")
        telemetry["signals"] = phase_telemetry_signals(torch, runtime["preempt"])
        log("[runtime] " + json.dumps(runtime_summary(runtime), default=float))
        log("[telemetry] " + json.dumps(telemetry_summary(telemetry), default=float))
        log("[population] " + json.dumps(population_summary(population), default=float))
        log("[vecenv] " + json.dumps(vecenv_summary(vecenv), default=float))

        launches = {"rssm": train["counts"]["rssm"], "gru": train_gru["counts"]["gru"]}
        new_paths = {"p2e_explore": p2e, "p2e_finetune": finetune, "decoupled": decoupled}
        launches_by_path = {
            "rssm": {"serve": served["counts"]["rssm"], "train": train["counts"]["rssm"],
                     "train_per_update": train["per_update"][0]},
            "gru": {"serve": gru_served["counts"]["gru"], "train": train_gru["counts"]["gru"],
                    "train_per_update": train_gru["per_update"][0]},
        }
        for name, by_path in launches_by_path.items():
            for path, run_ in new_paths.items():
                by_path[path] = run_["counts"][name]
                by_path[f"{path}_per_update"] = max(n[name] for n in run_["update_launches"])
            by_path["family"] = sum(r["counts"][name] for r in family.values())
            by_path["ppo_train"] = ppo["counts"][name]
            by_path["ppo_serve"] = ppo_served["counts"][name]
            by_path["a2c"] = on_policy["a2c_rmsprop"]["counts"][name] + on_policy["a2c_rmsprop_tf"]["counts"][name]
            by_path["ppo_recurrent"] = on_policy["ppo_recurrent"]["counts"][name]
            for algo, run_ in off_policy["train"].items():
                by_path[f"{algo}_train"] = run_["counts"][name]
            by_path["sac_serve"] = off_policy["serve"]["counts"][name]
            dv3_forage = envs["dv3_forage"]["train"]
            by_path["dv3_forage"] = dv3_forage["counts"][name]
            by_path["dv3_forage_per_update"] = max(n[name] for n in dv3_forage["update_launches"])
            by_path["anakin_ppo"] = envs["ppo"]["anakin"]["counts"][name]
            by_path["adapter_ppo"] = envs["ppo"]["adapter"]["counts"][name]
            for path, run_ in envs["family"].items():
                by_path[path.replace("-", "_")] = run_["counts"][name]
            by_path["ppo_atari_forage"] = envs["ppo_atari_forage"]["counts"][name]
            by_path["sac_pendulum"] = envs["sac_pendulum"]["counts"][name]
            by_path["replay_dv3_xl"] = replay["dv3"]["counts"][name]
            by_path["replay_dv3_xl_per_update"] = max(n[name] for n in replay["dv3"]["update_launches"])
            for path in ("train", "p2e"):
                by_path[f"bf16_{path}_xl"] = precision[path]["counts"][name]
                by_path[f"bf16_{path}_xl_per_update"] = max(n[name] for n in precision[path]["update_launches"])
            by_path["bf16_serve"] = sum(r["counts"][name] for r in precision["serve"]["bf16"])
            # the bf16 windows of phases 43-44 (XL with the RSSM kernel, S with the GRU kernel)
            window = precision["dv3_xl" if name == "rssm" else "dv3_s_gru"]
            by_path["bf16_window_per_update"] = window["launches_per_update"]
            # phases 48-49: the guarded windows (XL with the RSSM kernel, S with
            # the GRU kernel), the preempted XL run and its resumed run
            by_path["guarded_window_per_update"] = runtime["dv3_xl" if name == "rssm" else "dv3_s_gru"][
                "launches_per_update"]
            by_path["preempted_xl"] = runtime["preempt"]["preempted"][name]
            by_path["resumed_xl"] = runtime["preempt"]["resumed"][name]
            by_path["resumed_xl_first_window_per_update"] = runtime["preempt"]["resumed_first_window_per_update"][name]
            # phases 51-53: DV3-XL traced and untraced through cli.run, the launches
            # credited inside its two trace windows and the sheeprl:: kernels
            # their traces hold, the XL server hot-reloaded under load
            by_path["traced_xl"] = telemetry["traced"]["traced"]["counts"][name]
            by_path["untraced_xl"] = telemetry["traced"]["untraced"]["counts"][name]
            by_path["trace_windows_credited"] = sum(telemetry["traced"]["credited"]) if name == "rssm" else 0
            by_path["trace_windows_events"] = (sum(k["sheeprl"] for k in telemetry["traced"]["trace_kernels"])
                                               if name == "rssm" else 0)
            by_path["reload_serve"] = telemetry["reload"]["counts"][name]
            # phases 54-56: the DV3-XL run that registered its sub-models (phase 51's
            # untraced twin), the JAX-written fixture served by cli.serve (its
            # process's count), the two fleet replicas before the kill
            by_path["registered_xl"] = telemetry["traced"]["untraced"]["counts"][name]
            by_path["jax_snapshot_serve"] = deploy["jax_snapshot"]["launches"][name]
            by_path["fleet_serve"] = deploy["fleet"]["launches"][name]
            # phases 57-59: the PPO, A2C and multiroom populations (no RSSM or
            # LN-GRU in their agents) and the supervised DreamerV3-S children
            for path, run_ in population["train"].items():
                if path != "seconds":
                    by_path[f"population_{path}"] = run_["counts"][name]
            by_path["supervised_s"] = population["supervisor"]["launches"][name]
            # phases 60-62: DV3-XL with its envs in worker processes and on the
            # loop thread, the masked XL player, the watchdog drills' DV3-S
            # children, the JAX-written fixture resumed (and continued by auto)
            for tag, run_ in vecenv["xl"]["runs"].items():
                by_path[f"vecenv_{tag}_xl"] = run_["counts"][name]
                by_path[f"vecenv_{tag}_xl_per_update"] = max(n[name] for n in run_["update_launches"])
            by_path["masked_player_xl"] = vecenv["masks"]["counts"][name]
            by_path["watchdog_s"] = vecenv["watchdog"]["launches"][name]
            by_path["jax_resume"] = vecenv["jax_resume"]["counts"][name]
            by_path["jax_resume_per_update"] = max(n[name] for n in vecenv["jax_resume"]["first"]["update_launches"])
            # phases 63-64: the TF32 XL window of phase 63 (credited per replay,
            # outside the main-path counts beside phase 38's), the JAX-written
            # PPO population resumed through cli.run (no RSSM or LN-GRU)
            by_path["matmul_high_window_per_update"] = (graphs["tf32"]["launches_per_update"]["high"]
                                                        if name == "rssm" else 0)
            by_path["population_resume"] = vecenv["population_resume"]["counts"][name]
            # phases 66-69: phase 38's XL update with 4 world-model microbatches, and
            # 2 stages with 4 imagination row chunks under remat (credited per replay,
            # outside the main-path counts beside phase 38's); phase 39's S window under
            # remat; the decoupled PPO and SAC runs (no RSSM or LN-GRU)
            for key in PIPE_WINDOWS:
                by_path[f"pipeline_{key}_window_per_update"] = (graphs["pipeline"]["launches_per_update"][key]
                                                                if name == "rssm" else 0)
            by_path["remat_s_window_per_update"] = graphs["remat_s"]["launches_per_update"] if name == "gru" else 0
            by_path["ppo_decoupled"] = decoupled_algos["ppo"]["counts"][name]
            by_path["sac_decoupled"] = decoupled_algos["sac"]["counts"][name]
            # phases 70-72: the Sebulba split's PPO on host workers, its fused
            # device-env actor and its SAC (no RSSM or LN-GRU)
            for path, run_ in sebulba.items():
                by_path[f"sebulba_{path}"] = run_["counts"][name]
        sources = {
            "rssm": ("sheeprl_tpu_torch/csrc/rssm.cu",
                     "sheeprl_tpu/ops/rssm_pallas.py:70 (_rssm_kernel), sheeprl_tpu/ops/rssm_pallas.py:260 "
                     "(_rssm_kernel_tiled)"),
            "gru": ("sheeprl_tpu_torch/csrc/gru.cu", "sheeprl_tpu/ops/gru_pallas.py:41 (_gru_kernel)"),
        }
        kernels = []
        for name in ("rssm", "gru"):
            t = timing[name][rung[name]]
            kernels.append({
                "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
                "launches": launches[name], "launches_by_path": launches_by_path[name], "max_abs_err": worst[name],
                "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None, "gemm_library_ms": t["gemm_library_ms"],
                "shape": list(t["shape"]),
                "timing_by_batch": {str(b): {k: v for k, v in row.items() if k not in ("shape", "breakdown")}
                                    for b, row in timing[name].items()},
                "bf16_operands": {"max_abs_err": precision["kernels"]["worst"][name],
                                  "by_batch": {str(b): row for b, row in precision["kernels"][name].items()}},
            })
        log(f"[done] serve parity err {parity_err:.2e}; train parity {train_parity['diffs']['loss_rel']:.3g} rel; "
            f"XL training {train['updates_per_s']:.3f} updates/s; P2E-DV3 XL exploration {p2e['updates_per_s']:.3f} "
            f"updates/s (parity {p2e_parity['diffs']['loss_rel']:.3g} rel, h {p2e_parity['diffs']['latent_abs']:.3g}); "
            f"PPO-Atari {ppo['iterations_per_s']:.3f} iterations/s = {ppo['env_steps_per_s']:.1f} env steps/s (card vs "
            f"CPU parameter changes {ppo_parity['param_l2']:.3g} rel L2), served "
            f"{ppo_served['stats']['served']} actions; A2C-Atari {on_policy['a2c_rmsprop']['iterations_per_s']:.3f} / "
            f"{on_policy['a2c_rmsprop_tf']['iterations_per_s']:.3f} iterations/s (rmsprop / rmsprop_tf), recurrent PPO "
            f"{on_policy['ppo_recurrent']['iterations_per_s']:.3f} iterations/s; "
            + ", ".join(f"{algo} {r['updates_per_s']:.1f} updates/s" for algo, r in off_policy["train"].items())
            + f" (card vs CPU {', '.join(f'{a} {p_['param_l2']:.3g}' for a, p_ in off_policy['parity'].items())} rel "
            f"L2), SAC served {off_policy['serve']['stats']['served']} actions; Anakin PPO "
            f"{envs['ppo']['anakin']['env_steps_per_s']:.0f} env steps/s at 1024 envs (adapter "
            f"{envs['ppo']['adapter']['env_steps_per_s']:.0f} at 16), DV3-XL on forage "
            f"{envs['dv3_forage']['train']['updates_per_s']:.3f} updates/s; DV3-XL on the card's ring (window "
            f"{replay['dv3']['window']:,}) {replay['dv3']['updates_per_s']:.3f} updates/s beside the host ring's "
            f"{train['updates_per_s_events']:.3f} (CUDA events); DV3-XL under bf16-mixed "
            f"{precision['train']['updates_per_s']:.3f} updates/s through cli.run, replayed "
            f"{statistics.median(precision['dv3_xl']['updates_per_s']['graph']):.3f}; DV3-XL guarded window "
            f"{statistics.median(runtime['dv3_xl']['updates_per_s']['guarded']):.3f} updates/s beside unguarded "
            f"{statistics.median(runtime['dv3_xl']['updates_per_s']['unguarded']):.3f}, preempted run committed "
            f"{runtime['preempt']['signal_to_commit_s']:.2f} s after SIGTERM (phases 48 and 50 "
            f"{runtime['seconds']:.1f} s); traced DV3-XL equal to untraced in {telemetry['traced']['bit_for_bit']} of "
            f"{telemetry['traced']['tensors']} tensors, trace windows hold {telemetry['traced']['credited']} rssm "
            f"launches; hot reload under {SERVE_SESSIONS} sessions answered {telemetry['reload']['answered']} requests, "
            f"installed {telemetry['reload']['swap_s']:.2f} s after the commit with a "
            f"{telemetry['reload']['pause_ms']:.2f} ms pause (phases 51-53 {telemetry['seconds']:.1f} s); the fleet "
            f"{', '.join(f'{x:.1f}' for x in deploy['fleet']['fleet_actions_per_s'])} actions/s beside one server's "
            f"{', '.join(f'{x:.1f}' for x in deploy['fleet']['single_actions_per_s'])}, a SIGKILLed replica back in "
            f"{deploy['fleet']['kill']['respawn_s']:.1f} s with no request dropped (phases 54-56 "
            f"{deploy['seconds']:.1f} s); a PPO population of {POP_MEMBERS[0]} at "
            f"{population['train'][f'ppo_p{POP_MEMBERS[0]}']['env_steps_per_s']:.0f} env steps/s, "
            f"{population['train'][f'ppo_p{POP_MEMBERS[0]}']['kernels_per_phase']} / "
            f"{population['train'][f'ppo_p{POP_MEMBERS[1]}']['kernels_per_phase']} kernels per phase at P = "
            f"{POP_MEMBERS[0]} / {POP_MEMBERS[1]}, card vs CPU {population['parity']['param_l2']:.3g} rel L2; a "
            f"supervised DV3-S restarted {population['supervisor']['crash_to_update_s']:.1f} s after its crash to "
            f"step {population['supervisor']['steps'][-1]} (phases 57-59 {population['seconds']:.1f} s); DV3-XL on "
            f"4 envs in worker processes {vecenv['xl']['runs']['async']['updates_per_s']:.3f} updates/s beside "
            f"{vecenv['xl']['runs']['sync']['updates_per_s']:.3f} on the loop thread, equal bit for bit; "
            f"{vecenv['masks']['actions']} masked XL player actions, {vecenv['masks']['excluded']} excluded; a hung "
            f"env torn down and the run committed step {vecenv['watchdog']['hang_steps'][-1]}; the JAX fixture's "
            f"first resumed update card vs CPU {max(vecenv['jax_resume']['change_gap'].values()):.3g} rel L2; "
            f"DV3-XL with TF32 (matmul_precision=high) "
            f"{statistics.median(graphs['tf32']['updates_per_s']['high']):.3f} updates/s beside fp32's "
            f"{statistics.median(graphs['tf32']['updates_per_s']['highest']):.3f}; the JAX-written "
            f"population's first resumed phase card vs CPU {vecenv['population_resume']['param_l2']:.3g} rel L2 "
            f"(without Adam's state {vecenv['population_resume']['control_l2']:.3g}); DV3-XL with 4 world-model "
            f"microbatches {statistics.median(graphs['pipeline']['updates_per_s']['mb4']):.3f} updates/s, 2 stages "
            f"under remat {statistics.median(graphs['pipeline']['updates_per_s']['2stage_remat']):.3f}, beside "
            f"{statistics.median(graphs['pipeline']['updates_per_s']['base']):.3f}; decoupled PPO "
            f"{statistics.median(decoupled_algos['ppo']['env_steps_per_s']['decoupled']):.1f} env steps/s beside "
            f"{statistics.median(decoupled_algos['ppo']['env_steps_per_s']['coupled']):.1f}, decoupled SAC "
            f"{statistics.median(decoupled_algos['sac']['updates_per_s']['decoupled']):.1f} updates/s beside "
            f"{statistics.median(decoupled_algos['sac']['updates_per_s']['coupled']):.1f} (staleness "
            f"{decoupled_algos['sac']['staleness_max']}); Sebulba PPO on 2 env workers "
            f"{sebulba['ppo']['env_steps_per_s']:.1f} env steps/s, its fused actor at 1024 envs "
            f"{sebulba['fused']['env_steps_per_s']:.1f}, Sebulba SAC {sebulba['sac']['updates_per_s']:.1f} updates/s "
            f"(phases 70-72 {sum(r['seconds'] for r in sebulba.values()):.1f} s); env 0's videos "
            f"{vecenv['watchdog']['video']['frames']} (phases 60-65 with 49 and 59 {vecenv['seconds']:.1f} s); "
            f"total {time.perf_counter() - t_start:.1f} s")
    except BaseException:
        traceback.print_exc()
        return 1
    # the run's tree is left in build/ (the next run deletes it when it starts):
    # deleting it here took ≈ 20 s after the last phase
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
