"""The training loop: port of ``distributed_lion_tpu/train/loop.py`` (the
data-parallel path).

A :class:`Trainer` trains a list of named parameters under a loss function
``loss_fn(batch, seed) -> (loss, metrics)``, the JAX package's
``Trainer(params=..., loss_fn=...)`` form: ``seed`` is the microbatch's
dropout seed, None in eval, and ``batch`` a token tensor ``[B, T]`` or a
dict of ``[B, T]`` arrays, all split by rows: ``"tokens"`` and ``"mask"``
(padded SFT rows), or DPO's ``"chosen"``, ``"rejected"`` and their masks.
Eval reports every metric the loss function returns, and perplexity only
when it reports ``n_tokens`` (a token-level loss). Only the named
parameters train and have the flat buffers; a frozen base (LoRA) lives in
the loss function's closure. :meth:`Trainer.for_gpt2` and
:meth:`Trainer.for_llama` build the pretraining trainers; with
``vocab_chunks`` > 0 their loss streams the head through
``ops/xent.py`` (no ``[B, T, V]`` logits). A caller's own loss function
must say it consumes ``vocab_chunks`` (``_vocab_chunked``), else the
trainer refuses the flag rather than ignore it (JAX loop.py:791-800).
Lion over bfloat16 params at a learning rate below 1e-3 is warned about,
as the JAX trainer does (loop.py:774-790): the ±lr step is below a
bfloat16 ulp of the larger coordinates. ``telemetry`` counts a step's
voted coordinates in int32, as the JAX package does, and is refused
before any step where they reach 2³¹ (:func:`check_telemetry_size`).

One process per GPU. Each rank runs forward and backward on its shard of
the global batch, accumulating ``gradient_accumulation_steps``
microbatches into the flat grad buffer and averaging them. With
``async_grad`` (the reference's ``AsyncTrainer``) there is no gradient
collective at all: the optimizer's vote is the only cross-rank traffic.
With ``async_grad=False`` one ``all_reduce`` averages the flat grad buffer
(DDP's all-reduce): the AdamW baseline (``lion=False``,
``optim/optax_adapter.py``) runs so, as the reference's non-Lion branch,
and so does its ZeRO-1 form (``zero1``, ``optim/zero.py``: each rank keeps
the float32 moments of its 1/W chunk and one all-gather reassembles the
params; JAX loop.py:567-576 refuses it with ``lion`` or ``async_grad``).
``dcn_pipeline_depth`` d > 0 pipelines a ``hier:<g>`` wire's cross-group
leg over d steps (``optim.distributed_lion``); it needs ``lion`` and an
explicitly named ``hier:<g>`` wire (JAX :590-611). Each logged row of a
hier run carries ``dcn_overlap_frac``, and under the ``dcn_delay`` fault
``dcn_wait_s``, the link's residual waits drained from
``parallel.collectives.DCN_WAIT`` (a ``dcn_wait`` span on the
``dcn-link`` thread under ``journal``, JAX :1715-1745).
``grad_clip_norm`` clips by the rank's global norm;
unset, ``max_grad_norm`` (which selects stochastic binarization) clips,
since the stochastic quantizer is unbiased only where ``|u| <= r``.
The LR lives on the card and the loop reads no device value except at
``logging_steps``, in ``evaluate`` and at a checkpoint. With ``telemetry``
the optimizer's vote-health frame is folded into
``train.telemetry.VoteHealth`` on the card every step and drained into
``vote/*`` metrics at ``logging_steps``. Each logged row also carries
``data_wait_ms``, the mean time per step spent in ``next()`` of the data
iterator since the last row.

**Checkpoints.** With ``output_dir`` the trainer saves every
``save_steps`` steps into ``output_dir/checkpoints`` (``train/checkpoint.py``,
the JAX package's manifest and commit marker): every rank its own momentum
(``exp_avg/rank<r>.pt``: with ``async_grad`` each rank's momentum is its
own, the reference's resume keeps rank 0's only), rank 0 the params, the
step and data counters, the world, the optimizer's count (device and host
copies) and seed, under ``vote_every`` > 1 the replicated elected-sign
cache, with ``telemetry`` the vote-health accumulator, and under the DCN
pipeline every rank its ring (``dcn_ring/rank<r>.pt``). Under AdamW rank 0
writes the replicated count and moments instead of the momenta, and under
ZeRO-1 every rank its chunks of them (``zero1/rank<r>.pt``). At
construction it resumes from the newest step that verifies
(``resume_from_checkpoint``), falling back past torn or uncommitted ones,
and fails loudly when every candidate fails to restore. A checkpoint of
another world size is refused unless ``elastic_resume``, which remaps the
momenta (``optim.distributed_lion.remap_worker_momentum``; the elected
cache is replicated and passes through); AdamW, ZeRO-1 and the DCN ring
have no remap and refuse it (JAX loop.py:2309-2320). A checkpoint of
another ``vote_every`` is refused: its cache has another layout; so is one
of another ``dcn_pipeline_depth`` (JAX :2267-2285), whose ring holds
another number of steps in flight, and a schedule that rejoins a worker at
depth > 0 is refused when the trainer is built (JAX :881-894). The data
iterator then skips the consumed batches (``skip``, else replay), and the
restored count, host step count and seed make the dropout masks, the LR and
the stochastic draws those of an uninterrupted run.

**The vote guard, the NaN sentinel, the profiler and preemption** (JAX
loop.py:1160-1320, :1430-1471, :1665-1690, :1830-1863). ``vote_guard``
(``observe``/``enforce``, Lion only) builds the optimizer's guard and the
host quarantine machine (``train/vote_guard.py``); ``inject_poison``
(``train/resilience.parse_poison``) makes rank ``w`` a sick voter from
step ``s`` on, before clipping: NaN grads, zero grads (a frozen ballot) or
negated grads (a flipped one). ``nan_sentinel`` watches the loss and the
pre-clip grad norm (meaned over the ranks; under ``enforce`` over the
ranks whose norm is finite), and on a nonfinite value writes a crash
bundle (``train.telemetry.write_crash_bundle``, the guard's sick ranks in
it and in the reason) and raises ``FloatingPointError``; with
``trace_on_anomaly`` it first traces ``profile_num_steps`` more steps into
``<bundle>/trace``. The guard's observations and the sentinel's values are
copied to the host without waiting and read one step behind, after the
next step has been issued, as the JAX trainer reads them one dispatch
behind: a quarantine lands on the same step as there. ``profile_dir``
traces ``[profile_start_step, + profile_num_steps)``
(``train/profiling.py``). ``on_preempt="save_exit"`` (the default)
installs a SIGTERM flag (``resilience.PreemptionGuard``) read at every
step boundary: the run writes a checkpoint tagged ``preempt``, commits it
and returns with ``preempted`` set. Each rank sees its signal at its own
time, so at W > 1 the ranks agree: each boundary starts an ``all_reduce``
(MAX) of the flag on a gloo group of its own and the next boundary reads
it, so every rank stops at the same step and no step waits for it. With a
guard, checkpoints carry the health mask (replicated) and each rank's
previous ballot, restored exactly (the mask through ``adopt_mask``); a
guard toggle across a resume attaches fresh guard state or strips it; an
elastic resume re-averages quarantined ranks' momenta from the healthy
mean before the remap.

**The run journal and the control plane** (JAX loop.py:313-358,
:726-761, :1160-1245, :1612-1620, :1770-1815, :1960-1978, :2087-2107).
``journal`` comes up first and closes last: a ``train/journal.Journal``
per rank process (``journal_rank<r>.jsonl`` under ``journal_dir``, default
``output_dir/journal``; ring-only with neither), installed as the active
journal, so the trainer's messages (rank 0 prints them, every rank journals
them), the vote guard's transitions, the checkpointer's spans, the
preemption drain and the data path's shard events land in one stream that
``cli/run_analyze.py`` reads. The loop's spans are host wall clock:
``data_wait`` (``next()`` and the host-to-device copy), ``dispatch`` (the
step: in eager PyTorch the host time issuing its kernels, and at W > 1
over gloo every collective the host blocks on), ``dispatch/guard`` and
``dispatch/membership`` (the plane's decisions and the state surgery they
order: a heal gathers the momenta over the ranks), ``device_wait`` (the
log-cadence sync the loop already makes: the ranks' metric mean and
``torch.cuda.synchronize``), ``device_wait/guard`` and
``device_wait/sentinel`` (the one-step-behind reads of the previous step's
host copies), ``logging_drain`` and ``eval``; events ``train_start``,
``step_log`` (with ``skew_steps``) and ``train_end``. No span reads a
tensor or adds a sync. ``control_plane`` (Lion only) arms the vote guard's
``enforce`` when it is off, refuses ``observe``, and runs a
``train/control_plane.ControlPlane`` on every rank with the same inputs:
``inject_membership`` (``worker_drop:<w>[:<step>]``,
``worker_rejoin:<w>:<step>``) is consumed at each step boundary before the
step, so a departed rank's ballot is masked out of the next election (the
rank keeps its process and its place in every collective, and its momentum
follows its own gradient), and a rejoiner's momentum is re-averaged from
the healthy mean and its previous ballot zeroed before it votes again.
Checkpoints carry the plane's ``cp_departed``, ``cp_sched_through``,
``cp_rejoining_until`` and ``cp_quarantine_counts``; a resume adopts them,
so a consumed drop or rejoin never replays. Under ``telemetry`` at W > 1
the first step runs under ``WIRE_TALLY.capture()`` and every row carries
``comm_measured_bytes_per_step``, ``comm_measured_calls_per_step`` and
``comm_drift_bytes`` (measured − ``profiling.comm_report``'s analytic
bytes) beside ``comm_bytes_per_step``, and ``host_step_skew`` (the ranks'
step counters' spread over a gloo side group).

**Tensor parallelism** (``tensor_parallel`` tp > 1, JAX loop.py:720-860,
:2395-2698, :2877-2915). The trainer takes a ``parallel.mesh.Grid``: the
vote, ``_mean_over_ranks``, the sentinel and the eval mean run on the data
group, the model's reductions on the tensor group, and the flat buffers
hold the rank's slices (``shard_rule`` names the split dim of each leaf),
so each data group votes on its own coordinates. Every decision of "rank
0" (the logger, the banners, the params of a checkpoint, the crash bundle)
is global rank 0's, and the journal and trace files are named by the
global rank. The pre-clip norm (``--max_grad_norm``, the sentinel) sums a
split leaf's squares over the tensor group and counts a replicated leaf
once. Checkpoints keep a data-parallel run's files: the params gathered
over the tensor group into whole JAX-layout leaves (global rank 0), each
data rank's momentum gathered the same way (its tensor rank 0); a resume
slices them, so a tp checkpoint resumes at another tp. The DCN pipeline's
ring is the exception: it holds a rank's own ballot bytes, one file a
tensor rank (``dcn_ring/rank<r>_tensor<t>.pt``), so a checkpoint with a
ring resumes only at its own tp (``check_resume_meta``). The JAX package's
refusals under split params hold, in its words: ``vote_every`` > 1,
``telemetry``, ``vote_guard`` (so ``control_plane``), ``zero1``, AdamW;
``tp_vocab`` without tp > 1 or with ``vocab_chunks``, and a vocabulary,
head count or width that does not divide. The banner's bits per param and
``comm_stats`` count the whole model's coordinates at the data world, as
the JAX package does.

**Sequence parallelism** (``seq_parallel`` sp > 1, JAX loop.py:387-401,
:761-771, :1396-1400, :2604-2661, :2810-2841). The grid's seq groups
(``parallel.mesh.make_grid``: sp consecutive ranks) split every row's
tokens: a rank takes its data rank's rows and its token columns
``[s·T/sp, (s+1)·T/sp)`` of each ``[B, T]`` leaf, in training and in eval.
The models run ring or Ulysses attention over the seq group
(``parallel/ring_attention.py``) and the loss is the chunk's
(``models.loss.clm_loss_seq_parallel``, ``ops.xent.
chunked_clm_loss_seq_parallel``, DPO's ``train.dpo`` logprobs), whose
gradient summed over the seq group is the whole sequence's: after
accumulation one ``all_reduce`` of the flat gradient buffer over the seq
group sums it, before the data mean, the clip, the sentinel and the vote.
The params are replicated over the seq group, so each seq rank votes in its
own data group on the same ballots and every seq rank's params and momentum
stay the same bits; AdamW, ``vote_every``, ``telemetry``, ``vote_guard``,
the control plane and the DCN pipeline run as at dp (a departure or a
rejoin is a data rank's, all its seq ranks together). A checkpoint holds a
dp run's files: seq rank 0 of each data rank writes what tensor rank 0
writes (its momentum, guard ballot and DCN ring); every "rank 0" decision
stays global rank 0's. Refused in the JAX words: ``zero1``, ``tp_vocab``,
a ``block_size`` that does not divide over sp or exceeds ``n_ctx``
(:func:`validate_seq_block`). GPT-2 skips attention-probability dropout
under sp (warned). ``remat_policy`` (programmatic, no flag: run_clm's
model-level ``--remat_policy`` sets the model config) overrides the model's
policy (:func:`apply_remat_policy`).

**Expert parallelism** (``expert_parallel`` ep > 1, GPT-2-MoE only; JAX
loop.py:612-622, :1320-1420, :2288-2328, :2484-2594). The grid's expert
groups (``parallel.mesh.make_grid``: ep consecutive ranks) split each MoE
block's experts (``expert_rule``, ``parallel.expert.expert_shard_dim``) and
each data rank's batch rows: rank ``(d, e)`` takes row shard ``d·ep + e`` of
``dp·ep`` (JAX's ``P((data, expert))`` batch), in training and in eval, so
the global batch is ``dp·ep·B·accum``. The loss is the rows' share
(``models.loss.clm_loss_sharded_rows``, its metrics summed over the expert
group), so after accumulation one ``all_reduce`` over the expert group sums
the gradient of every leaf replicated over it; an expert's own leaves
already hold every rank's cotangents through the return hop. The dropout
seed folds the expert rank. Each data group votes on its own ranks'
coordinates, as under tp, and composes with tp (dp × ep × tp); a seq axis,
``tp_vocab`` and ``vocab_chunks`` beside MoE are refused in the JAX words,
and so are ``vote_every``, ``telemetry`` and ``vote_guard`` under split
experts (at ep 1 and tp 1 a MoE model's params are replicated and they
run). ``ep_dcn_pipeline`` schedules the aux loss's load estimate: None the
rank's own, 0 the tallies summed over the expert group in the forward, d >
0 those of d steps before: ``LionState.moe_ring`` (``[d, n_moe, E+1]``
float32 per data rank, made here from the loss's ``_moe_tally_shape``; the
optimizer passes it through) is read at slot ``count mod d`` before the
step and that slot overwritten after the backward with the step's tallies,
summed over the microbatches and the expert group; no data-axis collective.
Checkpoints hold whole leaves (gathered over the tensor, then the expert
group; ``_whole``), each data rank's momentum and ring
(``moe_ring/rank<d>.pt``) written by its tensor, seq and expert rank 0, and
``ep_dcn_pipeline`` and ``expert_parallel`` in the meta; a resume at
another depth, or elastic with a ring, is refused in the JAX words (a
checkpoint's ep may differ: its leaves are whole). The banner and
``comm_stats`` state the whole model's coordinates.

**Pipeline parallelism** (``pipeline_parallel`` pp > 1, JAX
loop.py:196-200, :1401-1452, :1875-1882, :2432-2483, :2742-2787). The
grid's pipe groups (``parallel.mesh.make_grid``: rank ``r = (((d·tp +
t)·sp + s)·pp + p)·ep + e``) split the blocks into pp stages
(``models/gpt2_pipe.py``, ``models/llama_pipe.py``): each rank holds its
stage's blocks (``pipe_rule`` names them) and the replicated embedding, head
and final norm, and takes its data rank's rows (every stage the same), cut
into ``pipeline_microbatches`` (0: pp) GPipe microbatches
(``parallel/pipeline.py``). The pipelined loss runs its own backward: a
loss function marked ``_runs_backward`` returns a loss whose gradient is
already in the flat grad buffer, and the trainer does not call
``backward()`` on it. After accumulation one ``all_reduce`` over the pipe
group sums the replicated leaves' disjoint partials (stage 0's embedding,
the last stage's head and norm); the stage leaves' gradients are complete.
The pre-clip norm sums a stage leaf's squares over the pipe group and counts
a replicated leaf once. Each data group votes on its own stage's
coordinates; the banner and ``comm_stats`` state the whole model's count.
Composes with tp and sp (dp × tp × sp × pp); refused in the JAX words: an
expert axis or MoE beside it, ``tp_vocab``, and under params split over
``pipe`` ``vote_every``, ``telemetry``, ``vote_guard`` and AdamW/ZeRO-1;
dropout, a layer count or a batch that does not divide. Eval splits each
rank's batch into the microbatches too. Checkpoints hold whole leaves (over
tensor): each stage's params (``params/stage<p>.pt``, data rank 0's tensor
and seq rank 0) and each data rank's momentum of its stage
(``exp_avg/rank<d>_stage<p>.pt``), ``pipeline_parallel`` in the meta; a
checkpoint resumes only at its own pp (:func:`check_resume_meta`).

**Chunked dispatch** (``steps_per_call`` k > 1, JAX loop.py:220-223,
:1535-1556, :1618-1700, :1822-1827). A dispatch of k steps runs when
``min(k, max_steps - step)`` is k; a shorter tail runs step by step. The
chunk's k global batches are drawn, each rank's shards stacked
``[k, ...]`` and staged onto the device in one host-to-device copy, and the
k steps issued back to back with no host read between them (the JAX
trainer's ``lax.scan``; no CUDA graph is captured). Every step keeps its own
dropout seed, LR and poison step, so k-step chunks are ``torch.equal`` to k
single steps. The chunk's metrics are its steps' mean, the guard's
observations their sum (counts of bad steps, folded with ``advanced = k``),
and the sentinel reads the chunk's mean one dispatch behind. Membership,
the profiler window, preemption and the anomaly deadline act at dispatch
boundaries; logging, eval and save fire where the dispatch crossed a
multiple of their interval (``step % N < advanced``). The measured wire
ledger is the chunk's first step's, and the journal's ``data_wait`` and
``dispatch`` spans carry ``steps=k``.

``TrainConfig`` holds only the fields the port runs, with their JAX
defaults; the others (``row_block``, ``kernel``, …) are not flags here, so
argparse refuses them.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import time
from datetime import timedelta
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from distributed_lion_tpu_torch.models.gpt2 import GPT2, GPT2Config, fold_seed, n_moe_blocks
from distributed_lion_tpu_torch.models.gpt2_pipe import (
    GPT2Stage,
    make_pipeline_loss,
    pipeline_param_specs,
    pipeline_params,
    unpipeline_params,
    validate_pipeline,
)
from distributed_lion_tpu_torch.models.llama import Llama, LlamaConfig, as_parameters, llama_init
from distributed_lion_tpu_torch.models.llama_pipe import (
    LlamaStage,
    llama_pipeline_param_specs,
    llama_pipeline_params,
    make_llama_pipeline_loss,
    validate_llama_pipeline,
)
from distributed_lion_tpu_torch.models.loss import (
    clm_loss_and_metrics,
    clm_loss_seq_parallel,
    clm_loss_sharded_rows,
)
from distributed_lion_tpu_torch.ops.codec import (
    parse_wire,
    vote_chunk_elems,
    wire_bytes_per_param,
)
from distributed_lion_tpu_torch.ops.quant import map_tree
from distributed_lion_tpu_torch.ops.xent import (
    chunked_clm_loss_and_metrics,
    chunked_clm_loss_seq_parallel,
    tp_vocab_clm_loss_and_metrics,
)
from distributed_lion_tpu_torch.optim.distributed_lion import (
    distributed_lion,
    heal_rank_momentum,
    heal_worker_momentum,
    remap_worker_momentum,
)
from distributed_lion_tpu_torch.optim.lion import FlatParams, LionState, fresh_guard_state
from distributed_lion_tpu_torch.optim.optax_adapter import AdamWState, adamw
from distributed_lion_tpu_torch.optim.zero import Zero1State, adamw_zero1
from distributed_lion_tpu_torch.parallel import collectives
from distributed_lion_tpu_torch.parallel import tensor_parallel as tpar
from distributed_lion_tpu_torch.parallel.expert import AUX_WEIGHT, expert_shard_dim
from distributed_lion_tpu_torch.parallel.mesh import Grid, data_grid, resolve_device
from distributed_lion_tpu_torch.parallel.pipeline import stage_layers
from distributed_lion_tpu_torch.train import (
    control_plane,
    journal,
    resilience,
    telemetry,
    vote_guard,
)
from distributed_lion_tpu_torch.train.checkpoint import Checkpointer
from distributed_lion_tpu_torch.train.journal import emit
from distributed_lion_tpu_torch.train.metrics import MetricsLogger
from distributed_lion_tpu_torch.train.profiling import (
    StepProfiler,
    StepTimer,
    comm_report,
    peak_hbm_gb,
)
from distributed_lion_tpu_torch.train.schedule import (
    constant_schedule,
    cosine_schedule_with_warmup,
    linear_schedule_with_warmup,
)


@dataclasses.dataclass
class TrainConfig:
    """The slice's part of the JAX package's ``TrainConfig``, same names and
    defaults."""

    lion: bool = True
    async_grad: bool = True
    zero1: bool = False  # AdamW only: each rank keeps the moments of its 1/W chunk (optim/zero.py)
    wire: str = "auto"  # 'auto' → resolve_auto_comm
    vote_every: int = 0  # 0 = auto (1); K > 1: lazy sign refresh, a 1/K slice a step
    vote_buckets: int = 0  # 0 = auto (resolve_auto_comm)
    dcn_pipeline_depth: int = 0  # d > 0 (hier wire): consume the cross-group leg d steps later
    mom_dtype: str = ""  # Lion momentum dtype: '' = the param dtype, 'bfloat16'
    max_grad_norm: Optional[float] = None  # set → stochastic binarization
    grad_clip_norm: Optional[float] = None  # unset → clip at max_grad_norm
    telemetry: bool = False  # vote-health telemetry (train/telemetry.py)
    learning_rate: float = 1e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.99
    lr_scheduler_type: str = "cosine"  # cosine | linear | constant
    warmup_steps: int = 2000
    max_steps: int = 100_000
    per_device_train_batch_size: int = 20
    gradient_accumulation_steps: int = 8
    per_device_eval_batch_size: int = 20
    block_size: int = 1024
    seed: int = 42
    logging_steps: int = 50
    eval_steps: int = 1000
    eval_iters: int = 20
    save_steps: int = 1000
    save_total_limit: Optional[int] = 2
    output_dir: Optional[str] = None
    resume_from_checkpoint: bool = True
    async_ckpt: bool = True  # the write and commit run behind the next steps
    ckpt_integrity: bool = True  # sha256 manifest + COMMITTED marker, verified resume
    elastic_resume: bool = False  # resume another world size, momenta remapped
    vocab_chunks: int = 0  # > 0: the chunked-vocabulary cross entropy (ops/xent.py)
    on_preempt: str = "save_exit"  # save_exit | off: SIGTERM saves a 'preempt' step, returns
    profile_dir: Optional[str] = None  # trace a window of steps (train/profiling.py)
    profile_start_step: int = 10
    profile_num_steps: int = 3
    nan_sentinel: bool = False  # loss / pre-clip grad norm watch: crash bundle + raise
    trace_on_anomaly: bool = False  # with nan_sentinel: trace profile_num_steps first
    vote_guard: str = "off"  # off | observe | enforce (train/vote_guard.py)
    min_quorum: int = 0  # enforce: refuse below this many healthy ranks; 0 = W//2 + 1
    guard_strikes: int = 3  # bad observed steps before a quarantine
    guard_cooldown: int = 50  # steps in quarantine before a readmission probe
    inject_poison: str = ""  # '<kind>:<worker>[:<start_step>]' (resilience.parse_poison)
    journal: bool = False  # run journal (train/journal.py): spans and events, JSONL per rank
    journal_dir: str = ""  # '' = output_dir/journal; with neither, ring-only
    control_plane: bool = False  # membership lifecycle (train/control_plane.py); arms enforce
    rejoin_probe_steps: int = 0  # a rejoiner's probation; 0 = guard_cooldown
    inject_membership: str = ""  # 'worker_drop:<w>[:<s>],worker_rejoin:<w>:<s>' (needs the plane)
    tensor_parallel: int = 1  # the tensor axis: tp consecutive ranks split the model
    tp_vocab: bool = False  # with tp > 1: split the embedding/head by vocabulary too
    seq_parallel: int = 1  # the seq axis: sp consecutive ranks split each row's tokens
    pipeline_parallel: int = 1  # the pipe axis: pp stages over the blocks (GPipe schedule)
    pipeline_microbatches: int = 0  # GPipe microbatches per accumulation step (0: pp);
    # bubble fraction (pp - 1)/(M + pp - 1)
    expert_parallel: int = 1  # the expert axis: ep consecutive ranks split the MoE experts
    # and a data rank's batch rows (the CLI's grid; run_clm's GPT-2-MoE)
    ep_dcn_pipeline: Optional[int] = None  # MoE balance feedback: None = each rank's
    # local aux; 0 = the tallies summed over the expert group in the forward; d > 0
    # = the summed tallies of d steps before, from LionState.moe_ring
    steps_per_call: int = 1  # optimizer steps a dispatch: k > 1 issues k steps back to
    # back from one staged [k, ...] batch copy, the tail shorter than k step by step
    remat_policy: str = dataclasses.field(default="", metadata={"cli": False})
    # '' = the model config's own; 'full' | 'dots' overrides it (for_gpt2, for_llama)

    def schedule(self) -> Callable:
        if self.lr_scheduler_type == "cosine":
            return cosine_schedule_with_warmup(self.learning_rate, self.warmup_steps,
                                               self.max_steps)
        if self.lr_scheduler_type == "linear":
            return linear_schedule_with_warmup(self.learning_rate, self.warmup_steps,
                                               self.max_steps)
        if self.lr_scheduler_type == "constant":
            return constant_schedule(self.learning_rate)
        raise ValueError(f"unknown lr_scheduler_type {self.lr_scheduler_type!r}")


def apply_remat_policy(cfg: TrainConfig, model_cfg):
    """``cfg.remat_policy`` into the model config (JAX loop.py:368-384): ''
    keeps the model's; 'full' | 'dots' replaces it; refused when unknown or
    when the model does not rematerialize."""
    if not cfg.remat_policy:
        return model_cfg
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} (full | dots)")
    if not model_cfg.remat:
        raise ValueError(
            "TrainConfig.remat_policy set but the model config has remat=False — the policy "
            "would silently never apply; drop the override or enable remat")
    return dataclasses.replace(model_cfg, remat_policy=cfg.remat_policy)


def validate_seq_block(cfg: TrainConfig, model_cfg, sp: int) -> None:
    """The block must split evenly over the seq axis and fit the positions
    (JAX loop.py:387-401): past ``n_ctx`` the later chunks would have no
    position rows (GPT-2) or extrapolated rope angles (Llama)."""
    if cfg.block_size % sp:
        raise ValueError(f"block_size {cfg.block_size} not divisible by seq axis {sp}")
    if cfg.block_size > model_cfg.n_ctx:
        raise ValueError(
            f"seq-parallel block_size {cfg.block_size} (total tokens across the {sp}-way seq "
            f"axis) exceeds n_ctx {model_cfg.n_ctx}: the positional scheme (wpe table / rope "
            "range) is too small")


# Auto bucket trigger, kept at the JAX package's value, which was measured
# for a TPU; not measured on the H100 yet (ROADMAP Queue 1 item 4).
AUTO_BUCKET_MIN_COORDS = 16_000_000
# the ballot size from which auto names lazy refresh's saving (the JAX
# package's value); auto itself keeps vote_every at 1, as the JAX package's
AUTO_LAZY_MIN_PARAMS = 10_000_000


def resolve_auto_comm(cfg: TrainConfig, world: int, n_params: int,
                      nodes: int = 1, local_world: int = 1,
                      announce: bool = False, params_replicated: bool = True) -> TrainConfig:
    """Resolve ``wire='auto'``, ``vote_every=0`` and ``vote_buckets=0``, the
    JAX package's decision table (loop.py:436-532) with the torchrun world
    in place of the mesh: W=1 → sign_psum; several nodes whose local ranks
    form whole groups → hier:<local ranks>; else packed_a2a. vote_every →
    1; with ``announce``, a Lion run at W > 1 of at least
    ``AUTO_LAZY_MIN_PARAMS`` coordinates over replicated params (lazy
    refresh is refused over split ones) prints what ``--vote_every 4``
    would cut the wire to (JAX loop.py:489-500). vote_buckets → 4 when
    there is a wire and the ballot has at least ``AUTO_BUCKET_MIN_COORDS``
    coordinates, else 1."""
    if cfg.wire != "auto" and cfg.vote_every != 0 and cfg.vote_buckets != 0:
        return cfg
    wire, ve, vb = cfg.wire, cfg.vote_every, cfg.vote_buckets
    if wire == "auto":
        if not cfg.lion or world == 1:
            wire = "sign_psum"
        elif nodes > 1 and local_world > 1 and world % local_world == 0:
            wire = f"hier:{local_world}"
        else:
            wire = "packed_a2a"
    if ve == 0:
        ve = 1  # lazy refresh is opt-in, as in the JAX package
        if (announce and params_replicated and cfg.lion and world > 1
                and n_params >= AUTO_LAZY_MIN_PARAMS):
            bits = wire_bytes_per_param(n_params, world, wire, vote_every=4)["bits_per_param"]
            emit(f"[trainer] auto comm: wire={wire} vote_every=1 (strict every-step voting). "
                 f"Lazy --vote_every 4 would cut the {n_params / 1e6:.0f}M-coordinate ballot "
                 f"to {bits:.2f} bits/param/step, but it stays opt-in until a full-scale "
                 "lazy run matches strict voting's loss")
    if vb == 0:
        n_voted = (n_params if ve <= 1
                   else min(n_params, vote_chunk_elems(n_params, ve)))
        vb = 4 if (cfg.lion and world > 1 and n_voted >= AUTO_BUCKET_MIN_COORDS) else 1
    return dataclasses.replace(cfg, wire=wire, vote_every=ve, vote_buckets=vb)


def _resolve_for_world(cfg: TrainConfig, world: int, n_params: int,
                       announce: bool = False, tp: int = 1,
                       replicated: Optional[bool] = None) -> TrainConfig:
    """resolve_auto_comm with torchrun's host layout: ``LOCAL_WORLD_SIZE``
    ranks share a node, ``LOCAL_WORLD_SIZE / tp`` data ranks of it (``tp``
    the ranks of a data rank; JAX loop.py:455-466: the hier groups are data
    ranks sharing a host); params split over a tensor or expert axis are not
    ``replicated`` (default: tp 1; JAX :2405-2410)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world * tp))
    local = local // tp if local % tp == 0 else 0
    return resolve_auto_comm(cfg, world, n_params, nodes=max(1, world // max(local, 1)),
                             local_world=local, announce=announce,
                             params_replicated=tp == 1 if replicated is None else replicated)


def make_optimizer(cfg: TrainConfig, group=None):
    """The reference's optimizer wiring (run_clm.py:580-585): ``--lion`` →
    majority-vote Lion under the configured schedule; otherwise AdamW
    (``optim/optax_adapter.py``, weight decay ``cfg.weight_decay``) over
    synchronized grads, with ``zero1`` its ZeRO-1 form (``optim/zero.py``).
    The flag rules are the JAX package's (loop.py:563-611)."""
    if cfg.zero1 and cfg.lion:
        raise ValueError(
            "--zero1 applies only to the AdamW path; with --lion the optimizer "
            "state is the per-worker vote momentum, which ZeRO-1 sharding "
            "would silently drop — drop one of the two flags")
    if cfg.zero1 and cfg.async_grad:
        raise ValueError(
            "--zero1 requires synchronized gradients (async_grad=False): each "
            "worker updates the Adam-state chunk it owns, so all workers must "
            "see the same gradient for that chunk — with async_grad the "
            "all_gather would stitch together chunk-wise single-worker updates")
    if cfg.telemetry and not cfg.lion:
        raise ValueError(
            "--telemetry instruments the majority-vote election; the AdamW "
            "path has no vote to observe — drop one of the two flags")
    if vote_guard.parse_guard_mode(cfg.vote_guard) != "off" and not cfg.lion:
        raise ValueError(
            "--vote_guard protects the majority-vote election; the AdamW "
            "path has no vote to guard — drop one of the two flags")
    if cfg.dcn_pipeline_depth > 0:
        if not cfg.lion:
            raise ValueError(
                "--dcn_pipeline_depth pipelines the vote wire; the AdamW "
                "path has no vote collective — drop one of the two flags")
        if cfg.wire == "auto":
            raise ValueError(
                f"--dcn_pipeline_depth {cfg.dcn_pipeline_depth} needs an "
                "explicitly named hier wire, but the wire is the "
                "unresolved 'auto' sentinel — pass --wire hier:<g>")
        if parse_wire(cfg.wire)[0] != "hier":
            raise ValueError(
                f"--dcn_pipeline_depth {cfg.dcn_pipeline_depth} pipelines "
                f"the hier wire's level-2 (DCN) leg, but the wire here is "
                f"{cfg.wire!r} — a wire without a DCN leg has nothing to "
                "overlap; pass --wire hier:<g>")
    _check_ep_dcn_pipeline(cfg)
    if not cfg.lion:
        if cfg.async_grad:
            raise ValueError(
                "--async_grad without --lion would let replicas diverge (no "
                "grad sync and no vote); the reference silently permits this "
                "broken combination — we refuse it")
        if cfg.zero1:
            return adamw_zero1(cfg.schedule(), weight_decay=cfg.weight_decay, group=group)
        return adamw(cfg.schedule(), weight_decay=cfg.weight_decay)
    return distributed_lion(
        cfg.schedule(), b1=cfg.beta1, b2=cfg.beta2,
        weight_decay=cfg.weight_decay, group=group,
        max_grad_norm=cfg.max_grad_norm, seed=cfg.seed,
        wire="sign_psum" if cfg.wire == "auto" else cfg.wire,
        vote_every=cfg.vote_every or 1, vote_buckets=cfg.vote_buckets or 1,
        mom_dtype=cfg.mom_dtype or None, telemetry=cfg.telemetry, guard=cfg.vote_guard,
        dcn_pipeline_depth=cfg.dcn_pipeline_depth,
    )


def _check_ep_dcn_pipeline(cfg: TrainConfig) -> None:
    """``--ep_dcn_pipeline``'s flag rules (JAX loop.py:612-622)."""
    if cfg.ep_dcn_pipeline is None:
        return
    if cfg.ep_dcn_pipeline < 0:
        raise ValueError(f"--ep_dcn_pipeline must be >= 0, got {cfg.ep_dcn_pipeline}")
    if cfg.ep_dcn_pipeline > 0 and not cfg.lion:
        raise ValueError(
            f"--ep_dcn_pipeline {cfg.ep_dcn_pipeline} stores the "
            "in-flight MoE balance tallies on LionState.moe_ring; the "
            "AdamW path has no per-worker optimizer state to carry "
            "them — use --lion, or --ep_dcn_pipeline 0 (the "
            "synchronous global balance needs no ring)")


# telemetry's per-step counters (voted, valid, the margin histogram) are
# int32, as the JAX package's (train/telemetry.py:112-116)
TELEMETRY_MAX_VOTED = 2**31 - 1


def check_telemetry_size(n_params: int, vote_every: int, telemetry: bool) -> None:
    """Refuse ``telemetry`` where a step votes 2³¹ coordinates or more: its
    int32 counters would overflow, in the JAX package as here."""
    n_voted = (n_params if vote_every <= 1
               else min(n_params, vote_chunk_elems(n_params, vote_every)))
    if telemetry and n_voted > TELEMETRY_MAX_VOTED:
        raise ValueError(
            f"--telemetry counts a step's voted coordinates in int32, as the JAX package "
            f"does; this run votes {n_voted:,} coordinates a step, past 2**31 - 1. Drop "
            "--telemetry (wider counters: ROADMAP Queue 1 item 10; the limit is a "
            "reference-side fact of Queue 3)")


def arm_control_plane(cfg: TrainConfig) -> tuple[TrainConfig, bool]:
    """The control plane's flag rules (JAX loop.py:726-748): Lion only; it
    refuses ``--vote_guard observe`` (which never touches the mask) and arms
    ``enforce`` when the guard is off (every rank healthy, ``enforce`` is
    ``torch.equal`` to ``off``); ``inject_membership`` needs the plane.
    Returns the config and whether ``enforce`` was armed here."""
    armed = False
    if cfg.control_plane:
        if not cfg.lion:
            raise ValueError(
                "--control_plane drives the majority-vote election's membership mask; the "
                "AdamW path has no election — drop one of the two flags")
        if cfg.vote_guard == "observe":
            raise ValueError(
                "--control_plane needs masked elections to act on its membership decisions, "
                "but --vote_guard observe never touches the mask — use 'enforce' (or leave "
                "the guard off: the plane auto-arms enforce)")
        if cfg.vote_guard == "off":
            cfg = dataclasses.replace(cfg, vote_guard="enforce")
            armed = True
    if cfg.inject_membership and not cfg.control_plane:
        raise ValueError(
            "--inject_membership schedules live worker leave/join, which only the control "
            "plane consumes — pass --control_plane (or drop the injection)")
    return cfg, armed


def _refuse_split_params(cfg: TrainConfig, tp: int, axes: tuple = ("tensor",),
                         sp: int = 1) -> None:
    """The JAX trainer's refusals under params split over the mesh ``axes``
    (the tensor axis, the expert axis of an MoE model's experts, the pipe
    axis of a pipelined model's stages; JAX loop.py:761-771, 823-860), in
    its words."""
    axes = sorted(axes)
    if cfg.zero1 and tp > 1:
        raise ValueError(
            f"--zero1 is incompatible with a 'tensor' mesh axis of size {tp}: inside "
            "shard_map each tensor rank ravels its own local param shard, so the m/v chunks "
            "diverge across ranks while the out_specs assume tensor-replication — one rank's "
            "moments would silently win. Use pure data parallelism with ZeRO-1.")
    _refuse_zero1_seq(cfg, sp)
    _check_ep_dcn_pipeline(cfg)   # the optimizer's flag rules come first in JAX's order
    if not cfg.lion:
        raise NotImplementedError("tensor-parallel param_specs require the Lion path")
    if cfg.vote_every > 1:
        raise ValueError(
            f"--vote_every > 1 is incompatible with params sharded over {axes}: each rank's "
            "ballot covers its own local param shards, so the elected-sign caches differ "
            "across ranks while the P() spec declares them replicated — one rank's cache "
            "would silently win and stale signs would land on the wrong coordinates. Use "
            "lazy vote refresh with replicated params (dp / dp x sp).")
    if cfg.telemetry:
        raise ValueError(
            f"--telemetry is incompatible with params sharded over {axes}: each rank's "
            "ballot covers its own local shards, so the packed election state the "
            "accumulator carries would differ across ranks while its P() spec declares it "
            "replicated. Use vote-health telemetry with replicated params (dp / dp x sp).")
    if vote_guard.parse_guard_mode(cfg.vote_guard) != "off":
        raise ValueError(
            f"--vote_guard is incompatible with params sharded over {axes}: the guard's "
            "per-worker ballot state covers each rank's LOCAL shards, so health decisions "
            "would mix different coordinate sets. Use the vote guard with replicated params "
            "(dp / dp x sp).")


def _refuse_zero1_seq(cfg: TrainConfig, sp: int) -> None:
    """ZeRO-1 under a seq axis (JAX loop.py:761-771), in its words."""
    if cfg.zero1 and sp > 1:
        raise ValueError(
            f"--zero1 is incompatible with a 'seq' mesh axis of size {sp}: inside shard_map "
            "each seq rank ravels its own local param shard, so the m/v chunks diverge across "
            "ranks while the out_specs assume seq-replication — one rank's moments would "
            "silently win. Use pure data parallelism with ZeRO-1.")


def _check_tp_vocab(cfg: TrainConfig, tp: int, rows: int, gpt2: bool, sp: int = 1) -> None:
    """``--tp_vocab``'s rules (JAX loop.py:2596-2617, 2788-2816): ``rows``
    are GPT-2's padded embedding rows or Llama's vocabulary."""
    if not cfg.tp_vocab:
        return
    if tp <= 1:
        raise ValueError("--tp_vocab needs --tensor_parallel > 1 (it shards the "
                         + ("tied embedding" if gpt2 else "lm_head") + " over the tensor axis)")
    if cfg.vocab_chunks > 0:
        raise NotImplementedError(
            "--tp_vocab and --vocab_chunks are alternative head strategies; pick one")
    if sp > 1:
        raise NotImplementedError("--tp_vocab under --seq_parallel is not wired; pick one")
    if rows % tp:
        raise ValueError(
            f"--tp_vocab: embedding rows {rows} not divisible by tensor axis {tp}; "
            "vocab_pad_multiple (models/gpt2) pads a ragged vocab so it shards evenly" if gpt2
            else f"--tp_vocab: vocab {rows} not divisible by tensor axis {tp}")


LossFn = Callable[[object, Optional[int]], tuple]

# a checkpoint step's files (train/checkpoint.py): rank 0's, and each rank's
PARAMS_FILE = "params.pt"
STATE_FILE = "state.pt"
VOTE_HEALTH_FILE = "vote_health.pt"
ADAMW_FILE = "adamw.pt"  # AdamW's replicated moments


def _stage_suffix(stage: Optional[int]) -> str:
    return "" if stage is None else f"_stage{stage:05d}"


def params_file(stage: Optional[int] = None) -> str:
    """The params of a checkpoint step: the whole model's, or under a pipe
    axis pipeline stage ``stage``'s."""
    return PARAMS_FILE if stage is None else f"params/stage{stage:05d}.pt"


def momentum_file(rank: int, stage: Optional[int] = None) -> str:
    """Data rank ``rank``'s momentum (of its pipeline stage ``stage``'s
    leaves under a pipe axis)."""
    return f"exp_avg/rank{rank:05d}{_stage_suffix(stage)}.pt"


def ring_file(rank: int, tensor_rank: Optional[int] = None,
              expert_rank: Optional[int] = None, stage: Optional[int] = None) -> str:
    """The DCN pipeline's in-flight slots of ``rank`` (of its tensor,
    expert rank's and pipeline stage's slice under those axes: the slots are
    of a rank's own ballot)."""
    return (f"dcn_ring/rank{rank:05d}"
            + ("" if tensor_rank is None else f"_tensor{tensor_rank:05d}")
            + ("" if expert_rank is None else f"_expert{expert_rank:05d}")
            + _stage_suffix(stage) + ".pt")


def moe_ring_file(rank: int) -> str:
    """The MoE balance ring of data rank ``rank`` (``--ep_dcn_pipeline`` d >
    0): summed over the expert group, the same on every rank of it."""
    return f"moe_ring/rank{rank:05d}.pt"


def zero1_file(rank: int) -> str:
    """ZeRO-1's moment chunks of ``rank``."""
    return f"zero1/rank{rank:05d}.pt"


def prev_ballot_file(rank: int) -> str:
    """The vote guard's previous ballot of ``rank`` (the mask is in
    ``STATE_FILE``)."""
    return f"prev_ballot/rank{rank:05d}.pt"


def check_resume_meta(step: int, meta: dict, cfg: TrainConfig, tp: int, ep: int = 1,
                      pp: int = 1) -> None:
    """Refuse, before any file is read, a checkpoint whose in-flight state
    this run cannot take: a DCN ring written at another depth or, its files
    being a tensor and expert rank's each, at another tp or ep; an MoE
    balance ring written at another ``--ep_dcn_pipeline`` (JAX
    loop.py:2264-2298); one written at another pp, whose stages' files hold
    other blocks."""
    ckpt_pp = int(meta.get("pipeline_parallel", 1) or 1)
    if ckpt_pp != pp:
        raise ValueError(
            f"checkpoint step {step} was written at --pipeline_parallel {ckpt_pp}, and this run "
            f"has --pipeline_parallel {pp}: each pipeline stage's files hold its own blocks "
            "(params/stage<p>.pt, exp_avg/rank<r>_stage<p>.pt), which do not restage. Resume "
            f"at --pipeline_parallel {ckpt_pp}")
    # the ring's slots are the depth's in-flight steps: no remap
    ckpt_depth = int(meta.get("dcn_pipeline_depth", 0) or 0)
    if ckpt_depth != cfg.dcn_pipeline_depth:
        raise ValueError(
            f"checkpoint step {step} was written at "
            f"--dcn_pipeline_depth {ckpt_depth} but this run "
            f"uses {cfg.dcn_pipeline_depth}: the in-flight"
            " DCN tally ring does not survive a depth change. "
            "Resume with the matching depth (then change it at "
            "the NEXT fresh start), or point --output_dir "
            "elsewhere")
    ckpt_tp = int(meta.get("tensor_parallel", 1) or 1)
    if ckpt_depth > 0 and ckpt_tp != tp:
        raise ValueError(
            f"checkpoint step {step} was written at --tensor_parallel {ckpt_tp} with a DCN "
            f"ring, and this run has --tensor_parallel {tp}: the ring holds each tensor "
            "rank's own ballot bytes (dcn_ring/rank<r>_tensor<t>.pt), which do not reshard. "
            f"Resume at --tensor_parallel {ckpt_tp}")
    ckpt_ep = int(meta.get("expert_parallel", 1) or 1)
    if ckpt_depth > 0 and ckpt_ep != ep:
        raise ValueError(
            f"checkpoint step {step} was written at --expert_parallel {ckpt_ep} with a DCN "
            f"ring, and this run has --expert_parallel {ep}: the ring holds each expert "
            "rank's own ballot bytes (dcn_ring/rank<r>_expert<e>.pt), which do not reshard. "
            f"Resume at --expert_parallel {ckpt_ep}")
    # the MoE balance ring: its slot count is the staleness (None and 0 both
    # mean no ring)
    ckpt_moe = int(meta.get("ep_dcn_pipeline", 0) or 0)
    run_moe = int(cfg.ep_dcn_pipeline or 0)
    if ckpt_moe != run_moe:
        raise ValueError(
            f"checkpoint step {step} was written at "
            f"--ep_dcn_pipeline {ckpt_moe} but this run uses "
            f"{run_moe}: the in-flight MoE balance ring does "
            "not survive a depth change. Resume with the "
            "matching depth, or point --output_dir elsewhere")


class HostCopy:
    """A small device tensor copied to pinned host memory behind the work
    already queued, so reading it later waits for that work only and not
    for steps issued since (the JAX trainer's one-dispatch-behind read)."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _rows(batch, lo: int, hi: int):
    """Rows ``lo:hi`` of a batch: an array, or a dict of arrays."""
    if isinstance(batch, dict):
        return {k: v[lo:hi] for k, v in batch.items()}
    return batch[lo:hi]


def _seq_cols(batch, seq):
    """The seq rank's token columns of every ``[B, T]`` leaf of a batch."""
    if seq.size == 1:
        return batch
    t = (next(iter(batch.values())) if isinstance(batch, dict) else batch).shape[1] // seq.size
    lo, hi = seq.rank * t, (seq.rank + 1) * t
    if isinstance(batch, dict):
        return {k: v[:, lo:hi] for k, v in batch.items()}
    return batch[:, lo:hi]


def _to_device(batch, device):
    if isinstance(batch, dict):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}
    return torch.from_numpy(np.ascontiguousarray(batch).astype(np.int64)).to(device)


def _tokens_and_mask(batch):
    return (batch["tokens"], batch["mask"]) if isinstance(batch, dict) else (batch, None)


def clm_loss_fn(model, seq=None) -> LossFn:
    """``loss_fn(batch, seed)`` of a causal LM ``model(tokens, seed)``; a dict
    batch carries its loss mask to ``clm_loss_and_metrics``. Under a seq
    axis (``seq``, size > 1) the batch is a chunk of packed rows and the
    loss ``models.loss.clm_loss_seq_parallel``."""
    def loss_fn(batch, seed):
        if seq is not None and seq.size > 1:
            return clm_loss_seq_parallel(model(batch, seed), batch, seq)
        tokens, mask = _tokens_and_mask(batch)
        return clm_loss_and_metrics(model(tokens, seed), tokens, mask)
    return loss_fn


def chunked_clm_loss_fn(hidden_and_head: Callable, n_chunks: int, emb_layout: str = "vd",
                        valid_v: int = 0, seq=None) -> LossFn:
    """``loss_fn(batch, seed)`` of ``hidden_and_head(tokens, seed) ->
    (hidden [B, T, d], head)`` through the chunked-vocabulary cross entropy
    (``ops.xent.chunked_clm_loss_and_metrics``, under a seq axis
    ``chunked_clm_loss_seq_parallel``), marked ``_vocab_chunked``."""
    def loss_fn(batch, seed):
        if seq is not None and seq.size > 1:
            hidden, head = hidden_and_head(batch, seed)
            return chunked_clm_loss_seq_parallel(hidden, head, batch, n_chunks, seq,
                                                 emb_layout, valid_v)
        tokens, mask = _tokens_and_mask(batch)
        hidden, head = hidden_and_head(tokens, seed)
        return chunked_clm_loss_and_metrics(hidden, head, tokens, n_chunks, mask,
                                            emb_layout, valid_v)
    loss_fn._vocab_chunked = True
    return loss_fn


def _refuse_moe(cfg: TrainConfig, model_cfg: GPT2Config, sp: int, ep: int) -> None:
    """GPT-2's expert-axis and MoE refusals, in the JAX trainer's words and
    order (loop.py:2433-2437, 2485-2520)."""
    moe = model_cfg.moe_experts > 0
    if cfg.vocab_chunks > 0 and moe:
        raise NotImplementedError(
            "--vocab_chunks is wired for the dense dp/tp/sp/pp paths "
            "(the MoE branch carries its own loss function); drop one")
    if ep > 1 and not moe:
        raise ValueError(
            f"an 'expert' mesh axis of size {ep} needs MoE blocks "
            "(--moe_experts); a dense model would silently duplicate all "
            "compute across the axis")
    if cfg.ep_dcn_pipeline is not None and not moe:
        raise ValueError(
            "--ep_dcn_pipeline schedules the MoE balance feedback; a "
            "dense model (--moe_experts 0) has no routing to balance. "
            "Drop the flag or add --moe_experts")
    if not moe:
        return
    if sp > 1:
        raise NotImplementedError(
            "MoE composes with data, expert and tensor parallelism "
            "(dp x ep x tp); a seq axis alongside MoE is not wired")
    if model_cfg.moe_experts % ep:
        raise ValueError(
            f"moe_experts {model_cfg.moe_experts} not divisible by expert axis {ep}")
    if cfg.tp_vocab:
        raise NotImplementedError(
            "--tp_vocab on the MoE path is not wired (the MoE loss "
            "uses the replicated tied head); drop one")


def _moe_loss_fn(model: GPT2, cfg: TrainConfig, grid: Grid) -> LossFn:
    """GPT-2-MoE's ``loss_fn(batch, seed, moe_balance=None)`` (JAX
    loop.py:2526-2584): under the expert axis the rows' loss
    (``clm_loss_sharded_rows``, its metrics summed over the expert group),
    at ep 1 the dense loss + 0.01·aux with ``aux_loss`` reported;
    ``ep_dcn_pipeline`` 0 at ep > 1 sums the tallies over the expert group
    in the forward, d > 0 takes the ring's ``[n_moe, E+1]`` slot as
    ``moe_balance`` and returns this microbatch's tallies as
    ``metrics["moe_tallies"]`` (the trainer takes them out)."""
    ep = grid.ep
    depth = cfg.ep_dcn_pipeline
    balance_axis = grid.expert if (depth == 0 and ep > 1) else None

    def loss_fn(batch, seed, moe_balance=None):
        tokens, _ = _tokens_and_mask(batch)
        out = model(tokens, seed, moe_balance=moe_balance, moe_balance_axis=balance_axis,
                    return_aux=True, return_tallies=moe_balance is not None)
        logits, aux = out[0], out[1]
        if ep > 1:
            loss, metrics = clm_loss_sharded_rows(logits, tokens, grid.expert, aux=aux,
                                                  aux_weight=AUX_WEIGHT)
        else:
            loss, metrics = clm_loss_and_metrics(logits, tokens)
            metrics["aux_loss"] = aux.detach()
            loss = loss + AUX_WEIGHT * aux
        if moe_balance is not None:
            metrics["moe_tallies"] = out[2]
        return loss, metrics

    if (depth or 0) > 0:   # the trainer sizes LionState.moe_ring from it
        loss_fn._moe_tally_shape = (n_moe_blocks(model.cfg), model.cfg.moe_experts + 1)
    return loss_fn


def _announce(family: str, n: int, world: int, cfg: TrainConfig, device, tp: int = 1,
              sp: int = 1, ep: int = 1, pp: int = 1) -> None:
    """The trainer's banner (JAX loop.py:2722-2731): params, world (and tp,
    sp, pp and ep), and the vote wire with its bits per param per step, of
    the whole model's ``n`` coordinates as the JAX package counts them."""
    where = (f"world={world}" + (f" tp={tp}" if tp > 1 else "") + (f" sp={sp}" if sp > 1 else "")
             + (f" pp={pp}" if pp > 1 else "") + (f" ep={ep}" if ep > 1 else ""))
    if not cfg.lion:
        emit(f"[trainer] {family} {n/1e6:.1f}M params | {where} | AdamW"
             + (" ZeRO-1" if cfg.zero1 else "") + f", gradient all_reduce | device={device}")
        return
    acct = wire_bytes_per_param(n, world, cfg.wire, vote_every=cfg.vote_every,
                                accum_steps=cfg.gradient_accumulation_steps,
                                vote_buckets=cfg.vote_buckets,
                                dcn_pipeline_depth=cfg.dcn_pipeline_depth)
    emit(f"[trainer] {family} {n/1e6:.1f}M params | {where} | vote wire={cfg.wire}"
         + (f" (vote_buckets={cfg.vote_buckets})" if cfg.vote_buckets > 1 else "")
         + (f" (vote_every={cfg.vote_every})" if cfg.vote_every > 1 else "")
         + f": {acct['bits_per_param']:.2f} bits/param/step"
         + (f" | DCN leg {acct['dcn_bits_per_param']:.3f} bits/param"
            if "dcn_bits_per_param" in acct else "")
         + (f" | DCN pipeline depth {cfg.dcn_pipeline_depth}"
            if cfg.dcn_pipeline_depth > 0 else "")
         + f" | device={device}")


def _whole_count(named, rule, tp: int, expert_rule=None, ep: int = 1, pipe_rule=None,
                 pp: int = 1) -> int:
    """The coordinates of the whole leaves of which ``named`` holds slices
    (split by ``rule`` over tp and by ``expert_rule`` over ep), and under a
    pipe axis of pp equal stages, of every stage's (``pipe_rule`` names a
    stage's own leaves)."""
    return sum(math.prod(tpar.full_shape(
        tpar.full_shape(tuple(p.shape), rule(name) if tp > 1 else None, tp),
        expert_rule(name) if ep > 1 else None, ep))
        * (pp if pp > 1 and pipe_rule(name) else 1) for name, p in named)


# JAX loop.py:2457-2461, 2761-2765
TP_VOCAB_UNDER_PIPE = ("--tp_vocab under --pipeline_parallel is not wired (the pipeline loss "
                       "carries its own replicated head); drop one")


def announce_guards(trainer: "Trainer", prog: str) -> None:
    """The CLIs' banner lines for the DCN pipeline, ZeRO-1, the NaN
    sentinel, the vote guard (JAX run_clm.py:454-466), the control plane and
    the run journal, on rank 0 (every rank journals them)."""
    cfg = trainer.cfg
    say = trainer._emit
    if cfg.dcn_pipeline_depth > 0:
        d = cfg.dcn_pipeline_depth
        say(f"[{prog}] DCN pipeline depth {d} on {cfg.wire}: each step applies the election of "
            f"the ballots of {d} step(s) before, the first {d} step(s) decay only; "
            f"{trainer.state.dcn_ring.numel():,} bytes of in-flight slots a rank"
            + (f"; dcn_delay link {resilience.fault('dcn_delay')} s armed"
               if resilience.fault("dcn_delay") else ""))
    if cfg.zero1:
        say(f"[{prog}] ZeRO-1: AdamW moments sharded over {trainer.world} rank(s), "
            f"{8 * trainer.state.m.numel() / 1e6:.1f} MB of float32 state a rank (replicated: "
            f"{8 * trainer.n_params / 1e6:.1f} MB)")
    if cfg.nan_sentinel:
        say(f"[{prog}] NaN sentinel armed: a non-finite loss or pre-clip grad norm "
            + (f"writes a crash bundle to {cfg.output_dir}/crash/step_<n>/bundle.json and "
               if cfg.output_dir else "")
            + ("traces " + str(cfg.profile_num_steps) + " more steps, then "
               if cfg.trace_on_anomaly else "")
            + "raises FloatingPointError")
    if cfg.vote_guard != "off":
        say(f"[{prog}] vote guard {cfg.vote_guard.upper()}: per-worker ballot health inside "
            "the step (nonfinite / frozen / outlier), quarantine after "
            f"{cfg.guard_strikes} strikes, readmission probe after {cfg.guard_cooldown} steps, "
            f"refusing below quorum {trainer._guard.min_quorum}/{trainer.world}"
            + ("" if cfg.vote_guard == "enforce" else " (observe: elections untouched)"))
    if trainer._cplane is not None:
        say(f"[{prog}] control plane ON: one membership lifecycle per worker over "
            f"{trainer.world} rank(s); a departed worker's ballot is masked from the next "
            "election (no restart), a rejoiner's momentum re-averaged from the healthy mean, "
            f"probation {trainer._cplane.rejoin_probe_steps} steps"
            + (f"; membership schedule {cfg.inject_membership!r}" if cfg.inject_membership
               else ""))
    if cfg.journal:
        where = trainer.journal.directory
        say(f"[{prog}] run journal on: "
            + (f"{where}/{journal.journal_filename(trainer.global_rank)} per rank"
               if where else "ring-only (no --journal_dir or --output_dir)")
            + f"; python -m distributed_lion_tpu_torch.cli.run_analyze {where or '<dir>'}")


def report_preempted(trainer: "Trainer", prog: str) -> bool:
    """After ``train``: True when a preemption stopped it, with the CLIs'
    exit line (JAX run_clm.py:512-515); the CLI then returns, exit code 0."""
    if trainer.preempted:
        trainer._emit(f"[{prog}] preempted: "
                      + ("checkpoint durable, " if trainer.checkpointer
                         else "NO checkpointer (no --output_dir) — nothing saved, ")
                      + "exiting cleanly")
    return trainer.preempted


class Trainer:
    """Train/eval loop on one rank over ``named_params`` (in the JAX
    package's leaf order: the flat buffers' layout) and ``loss_fn``.
    ``grid`` is the dp × tp × sp × pp × ep grid (``parallel.mesh.make_grid``; a
    data-parallel run over a process group passes ``data_grid(group)``;
    None: a world of one) with ``shard_rule(name) -> dim or None`` naming
    the tensor split of each parameter and ``expert_rule(name)`` its expert
    split (module doc; given for an MoE model whose experts are split over
    the expert or tensor axis, as the JAX trainer's MoE param specs), and
    ``pipe_rule(name) -> bool`` whether a parameter is its pipeline stage's
    own (split over the pipe axis) rather than replicated over it; ``model``, where
    given, is the module ``loss_fn`` runs, for the caller (``for_gpt2``'s
    GPT-2: ``run_clm`` saves it). A ``loss_fn`` marked ``_runs_backward``
    (the pipelined models') puts its gradient into the params' ``.grad``
    itself, and the trainer does not call ``backward()`` on its loss."""

    def __init__(self, cfg: TrainConfig, named_params, loss_fn: LossFn, *, model=None,
                 grid: Optional[Grid] = None, shard_rule=None, expert_rule=None,
                 pipe_rule=None):
        grid = grid or data_grid()
        if grid.tp != cfg.tensor_parallel:
            raise ValueError(f"--tensor_parallel {cfg.tensor_parallel} but the grid's tensor "
                             f"axis is {grid.tp}: pass parallel.mesh.make_grid's grid")
        if grid.sp != cfg.seq_parallel:
            raise ValueError(f"--seq_parallel {cfg.seq_parallel} but the grid's seq axis is "
                             f"{grid.sp}: pass parallel.mesh.make_grid's grid")
        if grid.sp > 1 and cfg.block_size % grid.sp:
            raise ValueError(f"block_size {cfg.block_size} not divisible by seq axis {grid.sp}")
        self.grid, self.tensor, self.seq, self.expert = grid, grid.tensor, grid.seq, grid.expert
        self.pipe = grid.pipe
        self.world = grid.dp
        self.rank = grid.data_rank     # the vote's rank: seeds, momentum files
        # a data rank's batch rows split over its expert ranks (JAX's
        # P((data, expert)) batch): this rank's share of the global batch
        self._row_shard = grid.data_rank * grid.ep + grid.expert.rank
        self._row_shards = grid.dp * grid.ep
        self.global_rank = grid.rank   # files, logs and every "rank 0" decision
        self.chief = grid.rank == 0
        self.group = grid.data
        cfg, plane_armed = arm_control_plane(cfg)
        # the journal comes up first, so every message below is in it
        jdir = cfg.journal_dir or (os.path.join(cfg.output_dir, "journal")
                                   if cfg.output_dir else "")
        self.journal = (journal.Journal(jdir or None, rank=self.global_rank) if cfg.journal
                        else journal.NULL)
        if cfg.journal:
            journal.install(self.journal)
        if cfg.vocab_chunks > 0 and not getattr(loss_fn, "_vocab_chunked", False):
            raise NotImplementedError(
                "--vocab_chunks is not wired into this entry point's loss function "
                "(supported: run_clm, run_sft, run_dpo)")
        tp, ep = grid.tp, grid.ep
        self._dims = [None if tp == 1 or shard_rule is None else shard_rule(name)
                      for name, _ in named_params]
        self._edims = [None if ep == 1 or expert_rule is None else expert_rule(name)
                       for name, _ in named_params]
        # a stage's own leaves (split over the pipe axis), or replicated over it
        self._pdims = [grid.pp > 1 and pipe_rule is not None and bool(pipe_rule(name))
                       for name, _ in named_params]
        self._local_shapes = [tuple(p.shape) for _, p in named_params]
        self._mid_shapes = [tpar.full_shape(s, d, tp)   # whole over tensor, split over experts
                            for s, d in zip(self._local_shapes, self._dims)]
        self.full_shapes = [tpar.full_shape(s, d, ep)
                            for s, d in zip(self._mid_shapes, self._edims)]
        # the whole model's coordinates: what the JAX package counts (the
        # stages hold equal shares of the blocks)
        n = sum(math.prod(s) * (grid.pp if p else 1)
                for s, p in zip(self.full_shapes, self._pdims))
        self.n_global = n
        split_axes = ((("tensor",) if tp > 1 else ()) + (("expert",) if expert_rule else ())
                      + (("pipe",) if any(self._pdims) else ()))
        if split_axes:
            _refuse_split_params(cfg, tp, split_axes, grid.sp)
        _refuse_zero1_seq(cfg, grid.sp)
        self._loss_runs_backward = getattr(loss_fn, "_runs_backward", False)
        cfg = _resolve_for_world(cfg, self.world, n, announce=self.chief, tp=tp * ep * grid.pp,
                                 replicated=not split_axes)
        check_telemetry_size(n, cfg.vote_every, cfg.telemetry)
        self.cfg = cfg
        self.model = model
        self.loss_fn = loss_fn
        self.flat = FlatParams(named_params)
        if self.flat.mixed:
            raise NotImplementedError(
                f"params of mixed dtypes {[str(d) for d in self.flat.dtypes]}: the trainer's "
                "checkpoints, heals and crash bundles read one flat buffer; such a tree "
                "trains through optim.lion / optim.distributed_lion")
        if cfg.lion and cfg.learning_rate < 1e-3 and self.flat.params.dtype == torch.bfloat16:
            self._emit(f"[trainer] WARNING: bf16 param storage with Lion lr "
                       f"{cfg.learning_rate:g} < 1e-3 — the fixed ±lr update is below bf16 ULP "
                       "for |p| > ~lr*256, so those coordinates will NOT move. Use f32 "
                       "param_dtype (bf16 compute_dtype keeps the matmul speed) unless this is "
                       "a throughput bench.")
        self.device = self.flat.device
        self.n_params = self.flat.numel
        if cfg.steps_per_call < 1:
            raise ValueError(f"--steps_per_call must be >= 1, got {cfg.steps_per_call}")
        if cfg.on_preempt not in ("save_exit", "off"):
            raise ValueError(f"--on_preempt {cfg.on_preempt!r}: expected 'save_exit' (drain + "
                             "emergency checkpoint + clean return) or 'off'")
        self.opt = make_optimizer(cfg, self.group)
        self.state = self.opt.init(self.flat)
        if (cfg.ep_dcn_pipeline or 0) > 0:
            # the MoE balance ring: one [n_moe, E+1] tally slot per in-flight
            # step (JAX loop.py:936-953), its shape stamped by the MoE loss
            tshape = getattr(loss_fn, "_moe_tally_shape", None)
            if tshape is None:
                raise ValueError(
                    f"--ep_dcn_pipeline {cfg.ep_dcn_pipeline} > 0 "
                    "needs the MoE trainer's loss (make_trainer with "
                    "--moe_experts), which stamps the balance-tally "
                    "shape the ring is sized from; this loss carries "
                    "none")
            self.state = self.state._replace(moe_ring=torch.zeros(
                (cfg.ep_dcn_pipeline, *tshape), dtype=torch.float32, device=self.device))
        self._guard = (vote_guard.make_guard(self.world, cfg.vote_guard, cfg.guard_strikes,
                                             cfg.guard_cooldown, cfg.min_quorum,
                                             journal=self.journal)
                       if cfg.lion else None)
        self._guard_pending = None  # (step, HostCopy of the observations, steps)
        self._cplane = (control_plane.make_control_plane(
            self._guard, self.world, cfg.rejoin_probe_steps, cfg.dcn_pipeline_depth,
            journal=self.journal)
            if cfg.control_plane else None)
        if plane_armed:
            self._emit("[trainer] control plane: --vote_guard auto-armed to 'enforce' (the "
                       "plane's membership mask rides the guard's masked elections; "
                       "all-healthy enforce is bit-identical to off)")
        if cfg.inject_membership:
            sched = resilience.parse_membership_specs(cfg.inject_membership)
            bad = sorted({w for _, w, _ in sched if w >= self.world})
            if bad:
                raise ValueError(f"--inject_membership names worker(s) {bad} outside world "
                                 f"{self.world}: {cfg.inject_membership!r}")
            if cfg.dcn_pipeline_depth > 0 and any(k == "worker_rejoin" for k, _, _ in sched):
                # the elastic-resume depth rule, at construction
                raise ValueError(
                    "--inject_membership schedules a worker_rejoin but "
                    f"--dcn_pipeline_depth {cfg.dcn_pipeline_depth} > 0: "
                    "the in-flight DCN tally ring cannot re-absorb a "
                    "worker mid-flight (the same reason --elastic_resume "
                    "refuses depth > 0). Run the rejoin at depth 0")
            resilience.inject_fault("membership", sched)
            self._emit(f"[trainer] FAULT INJECTION armed: membership {cfg.inject_membership!r}")
        if cfg.inject_poison:
            resilience.inject_fault("ballot_poison", resilience.parse_poison(cfg.inject_poison))
            self._emit(f"[trainer] FAULT INJECTION armed: ballot poison {cfg.inject_poison!r}")
        self._metrics_window: collections.deque = collections.deque(maxlen=16)
        self._sentinel_pending = None  # (step, keys, HostCopy) awaiting the check
        self._sentinel_now = None  # this step's (keys, HostCopy): the logged grad_norm
        self._anomaly_deadline: Optional[int] = None  # the step the anomaly trace ends at
        self._anomaly_reason = ""
        self.preempted = False
        self._preempt = (resilience.PreemptionGuard(journal=self.journal)
                         if cfg.on_preempt == "save_exit" else None)
        # the ranks' agreement on the preemption flag and the step-skew
        # heartbeat ride a gloo group of their own, on the host: neither
        # waits for the card
        self._side = (
            collectives.side_group(grid.world, timedelta(seconds=1800))
            if grid.world is not None and (self._preempt is not None or cfg.telemetry
                                           or cfg.journal)
            and dist.get_world_size(grid.world) > 1
            else None)
        self._preempt_pending = None  # (work, flag) started at the last boundary
        self.profiler = StepProfiler(cfg.profile_dir, cfg.profile_start_step,
                                     cfg.profile_num_steps, cuda=self.device.type == "cuda",
                                     rank=self.global_rank)
        self.timer = StepTimer()
        self._wire_measured: Optional[dict] = None  # the first step's captured wire ledger
        self.margin_exact = telemetry.tally_wire(cfg.wire)
        self.vote_health = (telemetry.init_vote_health(self.n_params, cfg.vote_every,
                                                       self.device)
                            if cfg.telemetry else None)
        self._schedule = cfg.schedule()
        self.step_count = 0
        self._resume_skip_batches = 0
        # provenance stamps merged into every checkpoint's manifest meta
        # (run_clm: the native loader's served shards)
        self.data_meta: dict = {}
        self.history: list[dict] = []
        self.logger = MetricsLogger(cfg.output_dir if self.chief else None)
        # every process of the run writes into one step and agrees on its commit
        self.checkpointer = (
            Checkpointer(f"{cfg.output_dir}/checkpoints", cfg.save_total_limit,
                         async_save=cfg.async_ckpt, integrity=cfg.ckpt_integrity,
                         group=grid.world, journal=self.journal)
            if cfg.output_dir else None)
        t0 = time.perf_counter()
        self._maybe_resume()
        self.resume_s = time.perf_counter() - t0  # verify + restore, host clock

    def _emit(self, msg: str) -> None:
        """A trainer message: printed on global rank 0, journaled on every rank."""
        emit(msg, echo=self.chief)

    @property
    def _stage(self) -> Optional[int]:
        """This rank's pipeline stage, which names its checkpoint files; None
        without a pipe axis."""
        return self.pipe.rank if self.pipe.size > 1 else None

    @staticmethod
    def for_gpt2(cfg: TrainConfig, model_cfg: GPT2Config, *, device="cuda",
                 initial_params: Optional[dict] = None,
                 grid: Optional[Grid] = None) -> "Trainer":
        """A trainer for a fresh GPT-2 (init seeded by ``cfg.seed``) or for
        ``initial_params``, a state dict of whole leaves such as
        ``utils.serialization.params_from_jax`` returns. With
        ``vocab_chunks`` the loss streams the tied ``wte`` (``"vd"``, the
        padded rows masked by ``valid_v``; JAX loop.py:2685-2697). Under
        ``tensor_parallel`` (``grid``'s tensor axis; None: a world of one)
        the model holds this rank's slices, and with ``tp_vocab`` the loss is
        the vocab-parallel one over its ``wte`` rows (JAX :2596-2683). With
        ``moe_experts`` the model is GPT-2-MoE (JAX :2484-2594): under the
        expert axis (``grid``'s) each rank holds its experts and its data
        rank's share of the batch rows, and the loss is
        ``models.loss.clm_loss_sharded_rows`` with the aux; at ep 1 the dense
        loss + 0.01·aux; ``ep_dcn_pipeline`` feeds the aux the load summed
        over the expert group (0: in the forward; d > 0: of d steps before,
        from ``LionState.moe_ring``)."""
        device = resolve_device(device)
        grid = grid or data_grid()
        tp, sp, ep = grid.tp, grid.sp, grid.ep
        moe = model_cfg.moe_experts > 0
        if grid.pp > 1:
            return Trainer._gpt2_pipeline(cfg, model_cfg, device, initial_params, grid)
        _refuse_moe(cfg, model_cfg, sp, ep)
        if tp > 1:
            tpar.validate_tp(model_cfg, tp, "gpt2")
        _check_tp_vocab(cfg, tp, model_cfg.padded_vocab, gpt2=True, sp=sp)
        model_cfg = apply_remat_policy(cfg, model_cfg)
        if sp > 1:
            validate_seq_block(cfg, model_cfg, sp)
            if model_cfg.dropout > 0.0 and grid.rank == 0:
                emit("[trainer] WARNING: attention-probability dropout is disabled under "
                     "sequence parallelism (scores never exist in one place on the ring path); "
                     "residual/embedding dropout still applies — semantics differ from "
                     "replicated training at the same dropout rate")
        model = GPT2(model_cfg, device=device, seed=cfg.seed, tp=grid.tensor,
                     vocab_parallel=cfg.tp_vocab, seq=grid.seq, expert=grid.expert)
        if initial_params is not None:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(tpar.shard(tpar.shard(initial_params[name], model.shard_dim(name),
                                                  tp, grid.tensor.rank),
                                       model.expert_dim(name), ep, grid.expert.rank))
        named = model.jax_named_parameters()
        n = _whole_count(named, model.shard_dim, tp, model.expert_dim, ep)
        cfg = _resolve_for_world(cfg, grid.dp, n, announce=grid.rank == 0, tp=tp * ep,
                                 replicated=tp == 1 and ep == 1)
        if grid.rank == 0:
            _announce("GPT-2", n, grid.dp, cfg, device, tp, sp, ep)
        if moe:
            n_dense = n - _whole_count([(k, p) for k, p in named if ".moe." in k],
                                       model.shard_dim, tp, model.expert_dim, ep)
            if grid.rank == 0:
                emit(f"[trainer] GPT-2-MoE: {n/1e6:.1f}M total ({n_dense/1e6:.1f}M dense) | "
                     f"{model_cfg.moe_experts} experts every {model_cfg.moe_every} blocks | "
                     f"ep={ep}")
            return Trainer(cfg, named, _moe_loss_fn(model, cfg, grid), model=model, grid=grid,
                           shard_rule=model.shard_dim,
                           expert_rule=expert_shard_dim if (ep > 1 or tp > 1) else None)
        if cfg.tp_vocab:
            def loss_fn(batch, seed):
                tokens, mask = _tokens_and_mask(batch)
                # the rank's [V/tp, d] rows: the embedding's and, transposed, the head's
                return tp_vocab_clm_loss_and_metrics(model.hidden(tokens, seed), model.wte.t(),
                                                     tokens, grid.tensor, mask,
                                                     valid_v=model_cfg.vocab_size)
        elif cfg.vocab_chunks > 0:
            loss_fn = chunked_clm_loss_fn(lambda tokens, seed: (model.hidden(tokens, seed),
                                                                model.wte),
                                          cfg.vocab_chunks, valid_v=model_cfg.vocab_size,
                                          seq=grid.seq)
        else:
            loss_fn = clm_loss_fn(model, grid.seq)
        return Trainer(cfg, named, loss_fn, model=model, grid=grid, shard_rule=model.shard_dim)

    @staticmethod
    def _gpt2_pipeline(cfg: TrainConfig, model_cfg: GPT2Config, device, initial_params,
                       grid: Grid) -> "Trainer":
        """``for_gpt2`` under a pipe axis (JAX loop.py:2432-2483): this
        rank's stage (``models.gpt2_pipe.GPT2Stage``, its tensor slices
        under tp, its token chunk under sp) and the pipelined loss, after
        the JAX trainer's refusals in its words and order."""
        tp, sp, pp = grid.tp, grid.sp, grid.pp
        if cfg.vocab_chunks > 0 and model_cfg.moe_experts > 0:
            raise NotImplementedError(
                "--vocab_chunks is wired for the dense dp/tp/sp/pp paths "
                "(the MoE branch carries its own loss function); drop one")
        if grid.ep > 1:
            raise NotImplementedError(
                "pipeline parallelism composes with data, tensor and "
                "sequence parallelism (dp x tp x sp x pp); an expert "
                "axis alongside pipe is not wired")
        if model_cfg.moe_experts > 0:
            raise NotImplementedError(
                "MoE blocks under pipeline parallelism are not wired "
                "(mixed dense/MoE stage structures); drop one of the two")
        if cfg.tp_vocab:
            raise NotImplementedError(TP_VOCAB_UNDER_PIPE)
        if tp > 1:
            tpar.validate_tp(model_cfg, tp, "gpt2")
        model_cfg = apply_remat_policy(cfg, model_cfg)
        if sp > 1:
            validate_seq_block(cfg, model_cfg, sp)
        n_micro = cfg.pipeline_microbatches or pp
        validate_pipeline(model_cfg, cfg, pp, n_micro)
        stage = GPT2Stage(model_cfg, grid.pipe, device=device, seed=cfg.seed, tp=grid.tensor,
                          seq=grid.seq)
        named = stage.jax_named_parameters()
        specs = pipeline_param_specs(tensor=tp > 1)

        def rule(name):
            return specs(name)[1]

        def pipe_rule(name):
            return specs(name)[0]

        if initial_params is not None:
            mine = pipeline_params(initial_params, model_cfg.n_layer, grid.pipe)
            with torch.no_grad():
                for name, p in named:
                    p.copy_(tpar.shard(mine[name], rule(name), tp, grid.tensor.rank))
        n = _whole_count(named, rule, tp, pipe_rule=pipe_rule, pp=pp)
        cfg = _resolve_for_world(cfg, grid.dp, n, announce=grid.rank == 0, tp=tp * pp,
                                 replicated=False)
        if grid.rank == 0:
            _announce("GPT-2", n, grid.dp, cfg, device, tp, sp, pp=pp)
        return Trainer(cfg, named, make_pipeline_loss(stage, n_micro, cfg.vocab_chunks),
                       model=stage, grid=grid, shard_rule=rule, pipe_rule=pipe_rule)

    @staticmethod
    def for_llama(cfg: TrainConfig, model_cfg: LlamaConfig, *, device="cuda",
                  initial_params=None, grid: Optional[Grid] = None) -> "Trainer":
        """Full-parameter causal-LM training of a Llama (the dp and dp × tp
        branches of JAX loop.py:2701-2871): a fresh init seeded by
        ``cfg.seed`` or ``initial_params`` (a tree of whole leaves such as
        ``utils.serialization.llama_params_from_jax`` returns, cast to the
        param dtype), every leaf a parameter in the JAX leaf order; under
        ``tensor_parallel`` this rank's slices of it. The loss is the dense
        ``llama_apply`` one, or with ``vocab_chunks`` the final hidden states
        against the untied ``lm_head`` in its ``[d, V]`` layout (``"dv"``),
        or with ``tp_vocab`` the vocab-parallel one over the rank's
        ``lm_head`` columns; under ``seq_parallel`` the seq-parallel dense or
        chunked loss of the rank's token chunk. The model has no dropout. An
        expert axis is GPT-2-MoE's (refused, JAX :2721-2725). Under a pipe
        axis (JAX :2742-2787) the rank holds its stage
        (``models.llama_pipe.LlamaStage``, made by ``llama_init`` with its
        layers, or cut from ``initial_params``) and the loss is the pipelined
        one."""
        device = resolve_device(device)
        grid = grid or data_grid()
        if grid.ep > 1:
            raise NotImplementedError(
                "an 'expert' mesh axis is wired for GPT-2-MoE only; Llama "
                "composes with dp x tp x sp x pp")
        tp, sp, pp = grid.tp, grid.sp, grid.pp
        if pp > 1 and cfg.tp_vocab:
            raise NotImplementedError(TP_VOCAB_UNDER_PIPE)
        if tp > 1:
            tpar.validate_tp(model_cfg, tp, "llama")
        _check_tp_vocab(cfg, tp, model_cfg.vocab_size, gpt2=False, sp=sp)
        model_cfg = apply_remat_policy(cfg, model_cfg)
        if sp > 1:
            validate_seq_block(cfg, model_cfg, sp)

        def rule(name):
            return tpar.llama_shard_dim(name, cfg.tp_vocab) if tp > 1 else None

        if pp > 1:
            n_micro = cfg.pipeline_microbatches or pp
            validate_llama_pipeline(model_cfg, cfg, pp, n_micro)
            params = as_parameters(
                llama_init(model_cfg, seed=cfg.seed, device=device, tp=grid.tensor,
                           layers=stage_layers(model_cfg.n_layer, grid.pipe))
                if initial_params is None
                else map_tree(lambda t: t.to(device, model_cfg.param_dtype),
                              tpar.shard_tree(llama_pipeline_params(initial_params, grid.pipe),
                                              rule, tp, grid.tensor.rank)))
            stage = LlamaStage(model_cfg, grid.pipe, params, tp=grid.tensor, seq=grid.seq)
            named = stage.jax_named_parameters()

            def pipe_rule(name):
                return llama_pipeline_param_specs()(name)[0]

            n = _whole_count(named, rule, tp, pipe_rule=pipe_rule, pp=pp)
            cfg = _resolve_for_world(cfg, grid.dp, n, announce=grid.rank == 0, tp=tp * pp,
                                     replicated=False)
            if grid.rank == 0:
                _announce("Llama", n, grid.dp, cfg, device, tp, sp, pp=pp)
            return Trainer(cfg, named, make_llama_pipeline_loss(stage, n_micro, cfg.vocab_chunks),
                           model=stage, grid=grid, shard_rule=rule, pipe_rule=pipe_rule)

        # no reference to the initial tensors outlives the parameters: the
        # flat buffers take their place (at Llama-3-8B, 16 GB)
        params = as_parameters(
            llama_init(model_cfg, seed=cfg.seed, device=device, tp=grid.tensor,
                       vocab_parallel=cfg.tp_vocab) if initial_params is None
            else map_tree(lambda t: t.to(device, model_cfg.param_dtype),
                          tpar.shard_tree(initial_params, rule, tp, grid.tensor.rank)))
        model = Llama(model_cfg, params, tp=grid.tensor, seq=grid.seq)
        named = model.jax_named_parameters()
        n = _whole_count(named, rule, tp)
        cfg = _resolve_for_world(cfg, grid.dp, n, announce=grid.rank == 0, tp=tp)
        if grid.rank == 0:
            _announce("Llama", n, grid.dp, cfg, device, tp, sp)
        if cfg.tp_vocab:
            def loss_fn(batch, seed):
                tokens, mask = _tokens_and_mask(batch)
                # params["lm_head"] is this rank's [d, V/tp] columns
                return tp_vocab_clm_loss_and_metrics(model.hidden(tokens), params["lm_head"],
                                                     tokens, grid.tensor, mask)
        elif cfg.vocab_chunks > 0:
            loss_fn = chunked_clm_loss_fn(lambda tokens, seed: (model.hidden(tokens),
                                                                params["lm_head"]),
                                          cfg.vocab_chunks, emb_layout="dv", seq=grid.seq)
        else:
            loss_fn = clm_loss_fn(lambda tokens, seed: model(tokens), grid.seq)
        return Trainer(cfg, named, loss_fn, model=model, grid=grid, shard_rule=rule)

    def full_named(self) -> dict:
        """``{name: whole leaf}`` of the trained parameters, gathered over the
        tensor and expert groups, and under a pipe axis every stage's leaves
        on the host (a collective: every rank of the data rank calls it)."""
        views = self.flat.views(self.flat.params)
        whole = {name: tpar.gather(tpar.gather(views[name], dim, self.tensor), edim, self.expert)
                 for name, dim, edim in zip(self.flat.names, self._dims, self._edims)}
        if self.pipe.size == 1:
            return whole
        every = [None] * self.pipe.size
        dist.all_gather_object(every, {k: v.detach().cpu() for k, v in whole.items()},
                               group=self.pipe.group)
        return unpipeline_params(every)

    def comm_stats(self, steps_per_sec: Optional[float] = None) -> dict:
        """The vote's analytic wire bytes (JAX ``Trainer.comm_stats``,
        ``profiling.comm_report``'s keys): empty for AdamW and for a world
        of one, where no vote collective runs."""
        cfg = self.cfg
        if not cfg.lion or self.world <= 1:
            return {}
        # the whole model's coordinates under a tensor axis, as the JAX
        # package counts them (ROADMAP Queue 3: each rank's ballot is its slice)
        return comm_report(self.n_global, self.world, cfg.wire, steps_per_sec,
                           vote_every=cfg.vote_every,
                           accum_steps=cfg.gradient_accumulation_steps,
                           vote_buckets=cfg.vote_buckets or 1,
                           dcn_pipeline_depth=cfg.dcn_pipeline_depth)

    def global_train_batch(self) -> int:
        return (self._row_shards * self.cfg.per_device_train_batch_size
                * self.cfg.gradient_accumulation_steps)

    def _host_shard(self, batch):
        """This rank's shard of a global ``batch`` (its data rank's rows, or
        its expert rank's share of them; its seq rank's token columns), on
        the host."""
        accum, bs = self.cfg.gradient_accumulation_steps, self.cfg.per_device_train_batch_size
        r = self._row_shard
        return _seq_cols(_rows(batch, r * accum * bs, (r + 1) * accum * bs), self.seq)

    def _local_batch(self, batch):
        """This rank's shard of a global ``batch`` on the device."""
        return _to_device(self._host_shard(batch), self.device)

    def _stage_chunk(self, batches: list) -> list:
        """The shards of a chunk's global batches stacked ``[k, ...]`` and
        staged onto the device in one copy; returns each step's shard, a
        view of the staged stack."""
        shards = [self._host_shard(b) for b in batches]
        if isinstance(shards[0], dict):
            staged = _to_device({k: np.stack([s[k] for s in shards]) for k in shards[0]},
                                self.device)
            return [{k: v[i] for k, v in staged.items()} for i in range(len(shards))]
        return list(_to_device(np.stack(shards), self.device).unbind(0))

    def _dispatch(self, locals_: list) -> tuple:
        """``len(locals_)`` optimizer steps issued back to back, one a staged
        shard, with no host read between them (the JAX ``lax.scan`` of a
        chunk). Returns the steps' mean metrics, the sentinel's keys and
        values (their mean) and the guard's observations (their sum: counts
        of bad steps), the two last on their way to the host
        (:class:`HostCopy`) or None."""
        outs = []
        for local in locals_:
            if self._wire_measured is None and self.vote_health is not None and self.world > 1:
                # the measured wire ledger: the first step's launches
                out, self._wire_measured = telemetry.measure_step_wire(self._train_step, local)
            else:
                out = self._train_step(local)
            outs.append(out)
            self.step_count += 1
        if len(outs) == 1:
            metrics, sentinel, obs = outs[0]
        else:
            metrics = {k: torch.stack([m[k] for m, _, _ in outs]).mean(0) for k in outs[0][0]}
            sentinel = (None if outs[0][1] is None else
                        (outs[0][1][0], torch.stack([s[1] for _, s, _ in outs]).mean(0)))
            obs = None if outs[0][2] is None else torch.stack([o for _, _, o in outs]).sum(0)
        return (metrics, None if sentinel is None else (sentinel[0], HostCopy(sentinel[1])),
                None if obs is None else HostCopy(obs))

    def _train_step(self, local) -> tuple:
        """One optimizer step on this rank's shard ``local``
        (:meth:`_local_batch`) at ``step_count``; returns the
        microbatch-meaned local metrics, and the sentinel's keys and values
        and the guard's observations (device tensors each, or None)."""
        cfg = self.cfg
        accum, bs = cfg.gradient_accumulation_steps, cfg.per_device_train_batch_size
        self.flat.zero_grad()
        sums: dict = {}
        # the MoE balance ring: slot (count mod d) holds the tallies of step
        # count - d, read now and overwritten after the backward (JAX
        # loop.py:1348-1394)
        ring = getattr(self.state, "moe_ring", None)
        slot = stale = fresh = None
        if ring is not None:
            slot = self.state.steps % ring.shape[0]
            stale = ring[slot].clone()
        for i in range(accum):
            seed = fold_seed(cfg.seed + 1, self.rank, self.step_count, i)
            if self.expert.size > 1:   # the expert ranks hold other rows
                seed = fold_seed(seed, self.expert.rank)
            loss, metrics = self.loss_fn(_rows(local, i * bs, (i + 1) * bs), seed,
                                         *(() if ring is None else (stale,)))
            if not self._loss_runs_backward:
                loss.backward()
            if ring is not None:
                t = metrics.pop("moe_tallies")
                fresh = t if fresh is None else fresh + t
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        metrics = {k: v / accum for k, v in sums.items()}
        grads = self.flat.grads
        with torch.no_grad():
            grads.div_(accum)
            if ring is not None and self.expert.size > 1:
                # this data rank's tallies over its expert group; no data-axis
                # collective: each data rank balances against its own batch
                dist.all_reduce(fresh, group=self.expert.group)
            if self.seq.size > 1:
                # each seq rank's gradient is its chunk's share of the loss:
                # the whole sequence's is their sum (JAX loop.py:1396-1400)
                dist.all_reduce(grads, group=self.seq.group)
            if self.pipe.size > 1:
                # a replicated leaf's gradient is the stage's disjoint share
                # (stage 0 the embedding's, the last stage the head's): the
                # whole model's is their sum; a stage's blocks are complete
                # (JAX loop.py:1401-1417)
                self._sum_replicated(grads, self.pipe, 2)
            if self.expert.size > 1:
                # a replicated leaf's gradient is the rank's rows' share: the
                # whole batch's is their sum; an expert's own leaves already
                # got every rank's cotangents through the return hop (JAX
                # loop.py:1401-1417)
                self._sum_replicated(grads, self.expert, 1)
            if not cfg.async_grad:
                if self.group is not None:
                    dist.all_reduce(grads, group=self.group)
                grads.div_(self.world)
            self._inject_poison(grads)
            # pre-clip: clipping would hide the explosion the sentinel watches for
            gsq = self._global_grad_sq(grads) if cfg.nan_sentinel else None
            clip = (cfg.grad_clip_norm if cfg.grad_clip_norm is not None
                    else cfg.max_grad_norm)
            if clip:
                sq = gsq if gsq is not None else self._global_grad_sq(grads)
                scale = torch.clamp_max(clip / torch.clamp_min(torch.sqrt(sq), 1e-12), 1.0)
                grads.mul_(scale.to(grads.dtype))
        out = self.opt.step(self.flat, self.state)
        if type(out) is tuple:  # (state, *frames); a state is a NamedTuple
            self.state, *frames = out
        else:
            self.state, frames = out, []
        if ring is not None:   # the optimizer passed the ring through
            with torch.no_grad():
                ring[slot] = fresh
            self.state = self.state._replace(moe_ring=ring)
        if self.vote_health is not None:
            self.vote_health = telemetry.fold(self.vote_health, frames.pop(0), self.group,
                                              self.world, self.n_params)
        obs = self._guard_observations(frames.pop(0)) if self._guard is not None else None
        sentinel = self._sentinel_values(metrics, gsq) if gsq is not None else None
        return metrics, sentinel, obs

    def _global_grad_sq(self, grads: torch.Tensor) -> torch.Tensor:
        """The squared L2 norm of this rank's gradient (JAX ``global_grad_sq``,
        loop.py:2877-2915): under a tensor, expert or pipe axis a leaf's
        squares are summed over each axis that splits it, and a leaf
        replicated over an axis (its gradient whole on every rank of it)
        counts once, so every rank of a data rank gets the same value; never
        summed over the data group."""
        g32 = grads.to(torch.float32)
        if self.tensor.size == 1 and self.expert.size == 1 and self.pipe.size == 1:
            return torch.sum(torch.square(g32))
        zero = torch.zeros((), dtype=torch.float32, device=grads.device)
        parts: dict = {}
        for (off, n), key in self._split_runs():
            parts[key] = parts.get(key, zero) + torch.sum(torch.square(g32[off:off + n]))
        total = zero
        for key, part in sorted(parts.items()):
            for split, axis in zip(key, (self.tensor, self.expert, self.pipe)):
                if split:
                    part = tpar.reduce_from_tp_region(part, axis.group)
            total = total + part
        return total

    def _split_runs(self) -> list:
        """``((offset, length), (split over tensor, over experts, over
        pipe))`` over the flat buffer, adjacent leaves of one kind merged."""
        runs: list = []
        for off, shape, dim, edim, pdim in zip(self.flat.offsets, self._local_shapes, self._dims,
                                               self._edims, self._pdims):
            key = (int(tpar.spec_uses_axis(dim)), int(tpar.spec_uses_axis(edim)), int(pdim))
            n = math.prod(shape)
            if runs and runs[-1][1] == key:
                (o, m), _ = runs[-1]
                runs[-1] = ((o, m + n), key)
            else:
                runs.append(((off, n), key))
        return runs

    def _sum_replicated(self, grads: torch.Tensor, axis, which: int) -> None:
        """Sum the leaves replicated over ``axis`` (entry ``which`` of a
        :meth:`_split_runs` key) over its group, in place, by one
        ``all_reduce`` of their runs."""
        runs = [r for r, key in self._split_runs() if not key[which]]
        buf = torch.cat([grads[o:o + n] for o, n in runs])
        dist.all_reduce(buf, group=axis.group)
        for (o, n), part in zip(runs, buf.split([n for _, n in runs])):
            grads[o:o + n].copy_(part)

    def _inject_poison(self, grads: torch.Tensor) -> None:
        """``--inject_poison`` (JAX loop.py:1428-1448): this rank becomes a
        sick voter from the poison's start step on, before clipping: NaN
        grads (they poison the momentum; a NaN ballot votes −1), zero grads
        (the ballot freezes at sign(m)) or negated grads (an inverted voter)."""
        poison = resilience.fault("ballot_poison")
        if poison is None:
            return
        kind, worker, start = poison
        if self.rank != worker or self.step_count < start:
            return
        if kind == "nan_grads":
            grads.fill_(math.nan)
        elif kind == "frozen_ballot":
            grads.zero_()
        else:  # flipped_ballot
            grads.neg_()

    def _guard_observations(self, gframe: dict) -> torch.Tensor:
        """The guard frame as the ``vote_guard.OBS_KEYS`` rows of one
        ``[4, W]`` float64 tensor: nonfinite inputs, a frozen ballot (no bit
        flipped against a real previous vote), the disagreement fraction,
        and whether anything was voted."""
        voted = (gframe["voted"] > 0).expand(self.world)
        frozen = (gframe["flips"] == 0) & gframe["flip_valid"] & voted
        return torch.stack([(gframe["nonfinite"] > 0).double(), frozen.double(),
                            gframe["disagree"].double(), voted.double()])

    def _sentinel_values(self, metrics: dict, gsq: torch.Tensor) -> tuple:
        """The step's metrics meaned over the ranks and the pre-clip global
        grad norm, from one ``all_reduce``: the norm is the root of the
        ranks' mean squared norm, or under ``enforce`` of the mean over the
        ranks where it is finite (a quarantined rank's NaN must not trip the
        sentinel on a run the guard keeps healthy; JAX loop.py:1452-1471)."""
        keys = list(metrics)
        enforce = self.cfg.vote_guard == "enforce"
        finite = torch.isfinite(gsq)
        parts = ([torch.where(finite, gsq, 0.0), finite.to(torch.float32)] if enforce
                 else [gsq])
        vec = torch.stack([metrics[k].to(torch.float32) for k in keys] + parts)
        if self.group is not None:
            dist.all_reduce(vec, group=self.group)
        n = len(keys)
        norm = (torch.sqrt(vec[n] / torch.clamp_min(vec[n + 1], 1.0)) if enforce
                else torch.sqrt(vec[n] / self.world))
        return keys + ["grad_norm"], torch.cat([vec[:n] / self.world, norm[None]])

    def _mean_over_ranks(self, metrics: dict) -> dict:
        vals = torch.stack([v.to(torch.float32) for v in metrics.values()])
        if self.group is not None:
            dist.all_reduce(vals, group=self.group)
            vals = vals / self.world
        return dict(zip(metrics, vals.tolist()))

    def train(self, train_iter: Iterator, eval_blocks=None) -> list[dict]:
        """Step-based training to ``max_steps``; ``train_iter`` yields global
        batches of ``world*accum*per_device_bs`` rows (an array, or a dict
        of arrays), each rank taking its shard. Returns early, with
        ``preempted`` set, after a preemption's checkpoint."""
        cfg = self.cfg
        total = cfg.max_steps
        tokens_per_step = self.global_train_batch() * cfg.block_size
        if self._resume_skip_batches:
            # past the batches the checkpointed run consumed: by index
            # arithmetic where the iterator can seek, else by replay
            if hasattr(train_iter, "skip"):
                train_iter.skip(self._resume_skip_batches)
            else:
                for _ in range(self._resume_skip_batches):
                    next(train_iter)
            self._resume_skip_batches = 0
        t_last, s_last = time.perf_counter(), self.step_count
        data_wait = 0.0
        jr = self.journal  # journal.NULL when off: every span is a no-op
        jr.event("train_start", step=self.step_count, total=int(total))
        while self.step_count < total:
            if self._cplane is not None:
                # membership transitions land at the step boundary, before
                # the step: a due drop is masked out of this election, a due
                # rejoin healed before it votes
                with jr.span("dispatch/membership", step=self.step_count):
                    self._apply_membership(self.step_count)
            self.profiler.maybe_start(self.step_count)
            # a chunk of k steps where k fit before max_steps; the tail step by step
            k = min(cfg.steps_per_call, total - self.step_count)
            advanced = k if k == cfg.steps_per_call else 1
            with jr.span("data_wait", step=self.step_count, steps=advanced):
                t_data = time.perf_counter()
                batches = [next(train_iter) for _ in range(advanced)]
                data_wait += time.perf_counter() - t_data
                locals_ = (self._stage_chunk(batches) if advanced > 1
                           else [self._local_batch(batches[0])])
            with self.profiler.annotate(self.step_count), \
                    jr.span("dispatch", step=self.step_count, steps=advanced):
                metrics, sentinel, obs = self._dispatch(locals_)
            self.timer.tick(advanced)
            self.profiler.maybe_stop(self.step_count)
            if obs is not None:
                # the previous dispatch's observations, read now that this
                # one is issued: the JAX trainer's one-dispatch-behind read
                if self._guard_pending is not None:
                    self._apply_guard(*self._guard_pending)
                self._guard_pending = (self.step_count, obs, advanced)
            if sentinel is not None:
                if self._sentinel_pending is not None:
                    self._check_sentinel(*self._sentinel_pending)
                self._sentinel_pending = self._sentinel_now = (self.step_count, *sentinel)
            if self._anomaly_deadline is not None and self.step_count >= self._anomaly_deadline:
                # trace_on_anomaly: the armed window has captured its steps
                self.profiler.maybe_stop(self.step_count)
                if self.checkpointer:
                    self.checkpointer.finalize()
                raise FloatingPointError(self._anomaly_reason)
            # "crossed a multiple of N in this dispatch": a chunk never skips one
            if self.step_count % cfg.logging_steps < advanced or self.step_count == total:
                with jr.span("device_wait", step=self.step_count):
                    # the sync the loop makes at log cadence anyway (the
                    # ranks' metric mean reads the card), made a span
                    m = self._mean_over_ranks(metrics)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    if self._sentinel_now is not None:
                        _, keys, vals = self._sentinel_now
                        m["grad_norm"] = float(vals.get()[keys.index("grad_norm")])
                t_log = time.monotonic()
                now = time.perf_counter()
                steps = self.step_count - s_last
                steps_per_sec = steps / max(now - t_last, 1e-9)
                m["step_ms"] = 1e3 * (now - t_last) / steps
                m["tokens_per_sec"] = tokens_per_step * steps_per_sec
                m["lr"] = float(self._schedule(torch.tensor(self.step_count - 1)))
                m["data_wait_ms"] = 1e3 * data_wait / steps
                m.update(self.timer.stats())
                comm = self.comm_stats(steps_per_sec)
                if comm:
                    m["comm_bytes_per_step"] = comm["comm_bytes_per_step"]
                    m["comm_mbytes_per_sec"] = comm.get("comm_mbytes_per_sec", 0.0)
                    m["comm_overlap_frac"] = comm.get("comm_overlap_frac", 0.0)
                    if "dcn_overlap_frac" in comm:
                        m["dcn_overlap_frac"] = comm["dcn_overlap_frac"]
                dcn_waits = collectives.DCN_WAIT.pop()
                if dcn_waits:
                    # the emulated link's unhidden waits this interval (the
                    # dcn_delay fault only)
                    wait_s = sum(dcn_waits.values())
                    m["dcn_wait_s"] = wait_s
                    if cfg.journal:
                        # paid inside the step: run_analyze leaves the
                        # dcn-link thread out of the step attribution
                        jr.record({"kind": "span", "name": "dcn_wait", "dur": round(wait_s, 9),
                                   "step": self.step_count, "thread": "dcn-link"})
                hbm = peak_hbm_gb() if self.device.type == "cuda" else None
                if hbm is not None:
                    m["peak_hbm_gb"] = hbm
                data_wait = 0.0
                if self.checkpointer:
                    # seconds the loop was blocked on checkpointing since
                    # the last row
                    m["ckpt_stall_s"] = self.checkpointer.pop_stall_s()
                if hasattr(train_iter, "health_metrics"):
                    m.update(train_iter.health_metrics())
                t_last, s_last = now, self.step_count
                skew = None
                if self.vote_health is not None:
                    # the interval's one telemetry host read; the previous
                    # election carries over so flip rates stay continuous
                    vote = telemetry.drain(self.vote_health, self.margin_exact)
                    self.vote_health = telemetry.reset_counters(self.vote_health)
                    m.update({f"vote/{k}": v for k, v in vote.items()})
                    if self._wire_measured:
                        mw = self._wire_measured
                        m["comm_measured_bytes_per_step"] = mw["bytes_per_step"]
                        m["comm_measured_calls_per_step"] = mw["calls_per_step"]
                        if mw["dcn_bytes_per_step"]:
                            m["comm_measured_dcn_bytes_per_step"] = mw["dcn_bytes_per_step"]
                        if comm:
                            # 0 unless the accounting and the collectives disagree
                            m["comm_drift_bytes"] = (mw["bytes_per_step"]
                                                     - comm["comm_bytes_per_step"])
                    skew = telemetry.host_step_skew(self.step_count, self._side)
                    if skew is not None:
                        m["host_step_skew"] = skew
                elif cfg.journal:
                    skew = telemetry.host_step_skew(self.step_count, self._side)
                if self._guard is not None:
                    # the machine's state as of the last folded step
                    m.update(self._guard.summary(),
                             guard_healthy_mask=[bool(h) for h in self._guard.healthy],
                             guard_strikes=[int(x) for x in self._guard.strikes])
                if self._cplane is not None:
                    m.update(self._cplane.summary())
                self.history.append({"step": self.step_count, **m})
                self._metrics_window.append({"step": self.step_count, **m})
                if self.chief:
                    self.logger.log(self.step_count, m, prefix="train")
                if cfg.journal:
                    # the step-skew heartbeat as a journal event: run_analyze
                    # derives the cross-rank skew from these records
                    jr.event("step_log", step=self.step_count,
                             steps_per_sec=round(steps_per_sec, 6),
                             **({} if skew is None else {"skew_steps": int(skew)}))
                    # metric assembly, the telemetry drain and the write
                    jr.record({"kind": "span", "name": "logging_drain",
                               "dur": round(time.monotonic() - t_log, 9),
                               "step": self.step_count})
                    jr.flush()
            if eval_blocks is not None and self.step_count % cfg.eval_steps < advanced:
                with jr.span("eval", step=self.step_count):
                    self.history.append({"step": self.step_count,
                                         **self.evaluate(eval_blocks)})
            if self.checkpointer and self.step_count % cfg.save_steps < advanced:
                self.save()
            if self._preempt_due():
                if self._cplane is not None:
                    # the one membership stream records the departure too
                    self._cplane.note_preempt(self.step_count)
                self._preempt_exit()
                break
        self._drain_pending()
        jr.event("train_end", step=self.step_count, preempted=bool(self.preempted))
        jr.flush()
        return self.history

    def _drain_pending(self) -> None:
        """The last step's observations and sentinel values were still
        pending: fold and check them, so the machine's counters (and a
        quorum refusal) cover the whole run and a bundle names the sick
        ranks from the complete evidence (JAX loop.py:1853-1863)."""
        if self._guard_pending is not None:
            pending, self._guard_pending = self._guard_pending, None
            self._apply_guard(*pending)
        if self._sentinel_pending is not None:
            pending, self._sentinel_pending = self._sentinel_pending, None
            self._check_sentinel(*pending, force_raise=True)
        if self._preempt_pending is not None:
            work, _ = self._preempt_pending
            self._preempt_pending = None
            work.wait()

    def _preempt_due(self) -> bool:
        """Whether to stop at this step boundary. In a world of one, the
        flag itself; at W > 1 the MAX over the ranks of the flags each rank
        sent at the previous boundary, so every rank stops at the same
        step; this boundary's flags go out for the next one."""
        if self._preempt is None:
            return False
        local = self._preempt.should_stop()
        if self._side is None:
            return local
        due = False
        if self._preempt_pending is not None:
            work, flag = self._preempt_pending
            self._preempt_pending = None
            work.wait()
            due = bool(flag.item())
        if not due:
            flag = torch.tensor([int(local)], dtype=torch.int32)
            self._preempt_pending = (dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                                                     group=self._side, async_op=True), flag)
        return due

    def _preempt_exit(self) -> None:
        """Preemption at a step boundary: drain the in-flight save, commit
        a checkpoint tagged ``preempt`` and mark the run preempted."""
        if self.checkpointer:
            self._emit(f"[trainer] preemption at step {self.step_count}: draining in-flight "
                       "save, writing emergency checkpoint")
            self.save(tag="preempt")
            self.checkpointer.finalize()
        else:
            self._emit(f"[trainer] preemption at step {self.step_count}: no output_dir — "
                       "NOTHING SAVED; a restart begins from step 0")
        self.preempted = True

    # ---------------------------------------- guard, control plane, sentinel
    def _apply_guard(self, step: int, obs: HostCopy, advanced: int) -> None:
        """Fold one step's observations into the quarantine machine, or
        under ``control_plane`` into the plane's lifecycle, then act on the
        transitions under ``enforce`` (JAX loop.py:1207-1228)."""
        with self.journal.span("device_wait/guard", step=step):
            rows = obs.get()
        with self.journal.span("dispatch/guard", step=step):
            host = {"guard_nonfinite": rows[0].astype(np.int32),
                    "guard_frozen": rows[1].astype(np.int32),
                    "guard_disagree": rows[2].astype(np.float32),
                    "guard_voted_steps": np.asarray(int(rows[3][0]), np.int32)}
            if self._cplane is not None:
                events = self._cplane.observe(step, host, advanced)
                heal, reset_ballot, tag = events.heal, events.reset_ballot, "control plane"
            else:
                events = self._guard.update(step, host, advanced)
                heal, reset_ballot, tag = events.readmitted, [], "vote guard"
            for line in events.logs:
                self._emit(f"[trainer] {tag}: {line}")
            if self.cfg.vote_guard == "enforce":
                self._enforce_events(step, heal, reset_ballot, events.mask_changed)

    def _apply_membership(self, step: int) -> None:
        """Consume the membership schedule's due transitions at a step
        boundary, before the step (JAX loop.py:1230-1241)."""
        events = self._cplane.membership_due(step)
        for line in events.logs:
            self._emit(f"[trainer] control plane: {line}")
        if events.left or events.rejoined or events.mask_changed:
            self._enforce_events(step, events.heal, events.reset_ballot, events.mask_changed)

    def _enforce_events(self, step: int, heal: list, reset_ballot: list,
                        mask_changed: bool) -> None:
        """Act on the guard's or the plane's transitions (JAX
        loop.py:1160-1205): a readmitted or rejoining rank's momentum
        restarts at the healthy mean, a rejoiner's previous ballot is zeroed
        (the frozen-ballot XOR must not compare with a vote it cast before it
        left), the new mask goes to the optimizer state, and below the
        quorum the run refuses to continue, after the last checkpoint is
        committed."""
        if heal:
            source = np.array(self._guard.healthy, dtype=bool)
            source[heal] = False  # a healed rank is not its own source
            heal_rank_momentum(self.state.exp_avg, source, heal, self.group)
        if self.rank in reset_ballot and self.state.prev_ballot is not None:
            self.state.prev_ballot.zero_()
        if mask_changed:
            self.state = self.state._replace(
                health=torch.as_tensor(self._guard.healthy, device=self.device))
        if not self._guard.quorum_ok():
            if self.checkpointer:
                self.checkpointer.finalize()
            if self._cplane is not None:
                raise RuntimeError(self._cplane.quorum_error(step))
            raise RuntimeError(
                f"vote guard: healthy quorum {self._guard.healthy_count()}/{self.world} fell "
                f"below --min_quorum {self._guard.min_quorum} at step {step} — a majority "
                "election with a sick majority is noise, refusing to continue. Sick workers: "
                f"{self._guard.sick_workers()} (counters: "
                f"{self._guard.sick_report()['sick_workers']})")

    def _check_sentinel(self, step: int, keys: list, vals: HostCopy,
                        force_raise: bool = False) -> None:
        """The NaN sentinel's host half (JAX loop.py:1243-1320): on a
        nonfinite loss or pre-clip grad norm, write the crash bundle and
        raise ``FloatingPointError``; under ``trace_on_anomaly`` first arm
        a trace window of ``profile_num_steps`` steps into the bundle."""
        if self._anomaly_deadline is not None and not force_raise:
            return  # already tripped; the armed trace window is draining
        with self.journal.span("device_wait/sentinel", step=step):
            values = dict(zip(keys, (float(v) for v in vals.get())))
        bad = {k: values[k] for k in ("loss", "grad_norm")
               if k in values and not math.isfinite(values[k])}
        if not bad:
            return
        reason = ("non-finite " + ", ".join(f"{k}={v!r}" for k, v in bad.items())
                  + f" at step {step}")
        if self._guard is not None and self._guard.sick_workers():
            # a rank's NaN grads that lose every vote never reach the loss;
            # the guard's counters name it
            reason += f" (vote guard sick workers: {self._guard.sick_workers()})"
        self._emit(f"[trainer] ANOMALY: {reason}")
        crash_dir = None
        if self.cfg.output_dir:
            crash_dir = self._write_crash_bundle(step, reason, values)
        if self.cfg.trace_on_anomaly and not force_raise:
            trace_base = crash_dir or self.cfg.profile_dir
            if trace_base:
                # an open --profile_dir window closes before the anomaly's
                self.profiler.close()
                self.profiler = StepProfiler(os.path.join(trace_base, "trace"), self.step_count,
                                             self.cfg.profile_num_steps,
                                             cuda=self.device.type == "cuda",
                                             rank=self.global_rank)
                self._anomaly_deadline = self.step_count + self.cfg.profile_num_steps + 1
                self._anomaly_reason = reason
                self._emit(f"[trainer] armed anomaly trace window for steps "
                           f"[{self.step_count}, {self._anomaly_deadline - 1})")
                return
        if self.checkpointer:
            # the last good checkpoint is committed before the anomaly unwinds
            self.checkpointer.finalize()
        raise FloatingPointError(reason)

    def _write_crash_bundle(self, step: int, reason: str, values: dict) -> str:
        """Every rank counts its nonfinite momentum per leaf (summed over the
        ranks, as the JAX package counts its stacked momenta); rank 0 writes
        the bundle. Returns its directory."""
        counts = {"params": self._leaf_counts(self.flat.params)}
        if isinstance(self.state, LionState):
            counts["exp_avg"] = self._leaf_counts(self.state.exp_avg)
            if self.group is not None:
                dist.all_reduce(counts["exp_avg"], group=self.group)
        elif isinstance(self.state, Zero1State):  # the chunks, gathered to the flat layout
            for key in ("m", "v"):
                counts[key] = telemetry.nonfinite_leaf_counts(
                    self.flat, self._zero1_full(getattr(self.state, key)))
        else:  # AdamW: the replicated moments
            counts["mu"] = telemetry.nonfinite_leaf_counts(self.flat, self.state.mu)
            counts["nu"] = telemetry.nonfinite_leaf_counts(self.flat, self.state.nu)
        crash_dir = os.path.join(self.cfg.output_dir, "crash", f"step_{step:08d}")
        names = list(self.flat.names)
        if self.pipe.size > 1:   # every stage's leaves, a replicated one once
            every = [None] * self.pipe.size
            dist.all_gather_object(every, (names, {k: v.cpu() for k, v in counts.items()}),
                                   group=self.pipe.group)
            keep, seen = [], set()
            for j, (stage_names, _) in enumerate(every):
                for i, name in enumerate(stage_names):
                    if name not in seen:
                        seen.add(name)
                        keep.append((j, i))
            names = [every[j][0][i] for j, i in keep]
            counts = {k: torch.stack([every[j][1][k][i] for j, i in keep]) for k in counts}
        if self.chief:
            opt = {}
            for key in ("exp_avg", "mu", "nu", "m", "v"):
                if key in counts:
                    opt.update(telemetry.nonfinite_leaf_report(names, counts[key],
                                                               prefix=f".{key}"))
            window = list(self._metrics_window) + [{"step": step, "tripped": True, **values}]
            telemetry.write_crash_bundle(
                self.cfg.output_dir, step, reason, dataclasses.asdict(self.cfg),
                telemetry.nonfinite_leaf_report(names, counts["params"]), opt,
                window, guard=(self._cplane.report() if self._cplane is not None
                               else None if self._guard is None
                               else self._guard.sick_report()),
                journal_tail=self.journal.tail())
            self._emit(f"[trainer] crash bundle written to {crash_dir}")
        return crash_dir

    def _leaf_counts(self, buf: torch.Tensor) -> torch.Tensor:
        """Nonfinite values per leaf of a flat buffer, over the whole leaves:
        a split leaf's counts summed over the tensor group, a replicated
        leaf's taken once."""
        counts = telemetry.nonfinite_leaf_counts(self.flat, buf)
        for axis, dims in ((self.tensor, self._dims), (self.expert, self._edims)):
            if axis.size > 1:
                if axis.rank:
                    counts[[i for i, d in enumerate(dims) if not tpar.spec_uses_axis(d)]] = 0
                dist.all_reduce(counts, group=axis.group)
        return counts

    def _zero1_full(self, chunk: torch.Tensor) -> torch.Tensor:
        """A ZeRO-1 moment's chunks of every rank as one flat vector."""
        if self.group is None:
            return chunk[:self.n_params]
        full = chunk.new_empty(self.world * chunk.numel())
        collectives._all_gather(full, chunk, group=self.group)
        return full[:self.n_params]

    @torch.no_grad()
    def evaluate(self, eval_blocks) -> dict:
        """The mean of every metric the loss function reports over rows of an
        array or of a dict of arrays (``n_tokens`` aside), and perplexity =
        exp(loss) where it reports ``n_tokens``."""
        cfg = self.cfg
        per_dev = cfg.per_device_eval_batch_size
        n = len(next(iter(eval_blocks.values())) if isinstance(eval_blocks, dict)
                else eval_blocks)
        shards, r = self._row_shards, self._row_shard
        # under a pipe axis a rank's batch splits into the GPipe microbatches
        # (JAX loop.py:1875-1882)
        div = (cfg.pipeline_microbatches or self.pipe.size) if self.pipe.size > 1 else 1
        if n < shards * per_dev:
            per_dev = n // shards // div * div  # shrink rather than skip a small split
        bs = shards * per_dev
        if per_dev == 0:
            self._emit(f"[trainer] eval skipped: {n} examples < {shards} ranks")
            return {"eval/loss": math.nan, "eval/accuracy": math.nan,
                    "eval/perplexity": math.nan}
        per_key: dict = {}
        for i in range(min(cfg.eval_iters, n // bs)):
            rows = _rows(eval_blocks, i * bs + r * per_dev, i * bs + (r + 1) * per_dev)
            _, metrics = self.loss_fn(_to_device(_seq_cols(rows, self.seq), self.device), None)
            for k, v in self._mean_over_ranks(metrics).items():
                per_key.setdefault(k, []).append(v)
        out = {f"eval/{k}": float(np.mean(v)) for k, v in per_key.items() if k != "n_tokens"}
        if "n_tokens" in per_key:  # a token-level loss: perplexity applies
            out["eval/perplexity"] = float(np.exp(min(out["eval/loss"], 80.0)))
        if self.chief:
            self.logger.log(self.step_count, out, prefix="")
        return out

    # ------------------------------------------------------------ checkpoints
    def _whole(self, buf: torch.Tensor) -> torch.Tensor:
        """A flat buffer over the whole leaves from every tensor and expert
        rank's (collective over the tensor group, then the expert group;
        ``buf`` itself at tp 1 and ep 1)."""
        mid = tpar.gather_flat(buf, self._local_shapes, self._dims, self.tensor)
        return tpar.gather_flat(mid, self._mid_shapes, self._edims, self.expert)

    def _slice(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's flat buffer from one over the whole leaves."""
        mid = tpar.shard_flat(full, self._mid_shapes, self._edims, self.expert.size,
                              self.expert.rank)
        return tpar.shard_flat(mid, self._local_shapes, self._dims, self.tensor.size,
                               self.tensor.rank)

    def _payload(self) -> dict:
        """This rank's files of a checkpoint: its momentum (its guard ballot
        and DCN ring), or its ZeRO-1 chunks, and on global rank 0 the params,
        the counters and the vote-health accumulator. Under a tensor axis the
        momentum and the params are gathered into whole leaves first, and
        each data rank's tensor rank 0 writes its momentum: a data-parallel
        run's files. Under a seq axis only seq rank 0 writes a data rank's
        files: its seq ranks hold the same bits. Under a pipe axis each
        stage writes its own params and momentum files."""
        st = self.state
        adam = not isinstance(st, LionState)
        tp, ep, first = self.tensor.size, self.expert.size, self.seq.rank == 0
        lead = first and self.tensor.rank == 0 and self.expert.rank == 0
        stage = self._stage
        files = {}
        if not adam:
            mom = self._whole(st.exp_avg)
            if lead:
                files[momentum_file(self.rank, stage)] = mom
        if not adam and st.prev_ballot is not None and first:
            files[prev_ballot_file(self.rank)] = st.prev_ballot
        if not adam and st.dcn_ring is not None and first:
            files[ring_file(self.rank, self.tensor.rank if tp > 1 else None,
                            self.expert.rank if ep > 1 else None, stage)] = st.dcn_ring
        if not adam and st.moe_ring is not None and lead:
            files[moe_ring_file(self.rank)] = st.moe_ring
        if isinstance(st, Zero1State):
            files[zero1_file(self.rank)] = {"m": st.m, "v": st.v}
        params = self._whole(self.flat.params) if self.rank == 0 else None
        if self.rank == 0 and lead:
            files[params_file(stage)] = {"names": list(self.flat.names),
                                         "shapes": [list(s) for s in self.full_shapes],
                                         "flat": params}
        if self.chief:
            files[STATE_FILE] = {"step": self.step_count, "batches_consumed": self.step_count,
                                 "world": self.world, "count": st.count}
            if isinstance(st, AdamWState):
                files[ADAMW_FILE] = {"mu": st.mu, "nu": st.nu}
            elif not adam:
                files[STATE_FILE].update(steps=int(st.steps), seed=self.opt.seed)
                if st.elected is not None:
                    files[STATE_FILE]["elected"] = st.elected
                if st.health is not None:
                    files[STATE_FILE]["health"] = st.health
            if self.vote_health is not None:
                files[VOTE_HEALTH_FILE] = {f.name: getattr(self.vote_health, f.name)
                                           for f in dataclasses.fields(self.vote_health)}
        return files

    def save(self, tag: str = "periodic") -> None:
        """Checkpoint the current step on every rank (all ranks call it)."""
        assert self.checkpointer is not None
        if self.checkpointer.latest_step() == self.step_count:
            return  # already saved at this step (a final save on a save_steps boundary)
        cfg = self.cfg
        meta = {"world": self.world, "tag": tag, "step": self.step_count,
                "batches_consumed": self.step_count,
                "has_vote_health": self.vote_health is not None,
                "has_guard": self._guard is not None,
                "wire": cfg.wire, "vote_every": cfg.vote_every,
                "dcn_pipeline_depth": cfg.dcn_pipeline_depth,
                "ep_dcn_pipeline": int(cfg.ep_dcn_pipeline or 0),
                "control_plane": self._cplane is not None,
                # a dp run's meta has no tp or ep: a resume reads 1
                **({"tensor_parallel": self.tensor.size} if self.tensor.size > 1 else {}),
                **({"expert_parallel": self.expert.size} if self.expert.size > 1 else {}),
                **({"pipeline_parallel": self.pipe.size} if self.pipe.size > 1 else {}),
                **self.data_meta}
        if self._cplane is not None:
            # departed-vs-quarantined, the consumed-schedule watermark, the
            # probation windows and the quarantine history (the mask rides
            # the state): a resume neither readmits a departed worker nor
            # replays a consumed drop or rejoin
            cp = self._cplane
            meta.update(cp_departed=sorted(int(w) for w in cp.departed),
                        cp_sched_through=int(cp.sched_through),
                        cp_rejoining_until=[int(x) for x in cp.rejoining_until],
                        cp_quarantine_counts=[int(x) for x in cp.quarantine_counts])
        self.checkpointer.save(self.step_count, self._payload(), meta=meta)

    def _restore_step(self, step: int, meta: dict, ckpt_world: int) -> None:
        """Load step ``step`` into this rank's buffers; every file is read
        and checked before anything is overwritten."""
        ck, cfg = self.checkpointer, self.cfg
        state = ck.restore(step, STATE_FILE)
        params = ck.restore(step, params_file(self._stage))
        flat = params["flat"]
        if (list(params["names"]) != self.flat.names
                or [tuple(s) for s in params["shapes"]] != self.full_shapes
                or flat.dtype != self.flat.params.dtype):
            raise ValueError(f"checkpoint step {step} holds other parameters than this run "
                             "(names, shapes or dtype)")
        flat = self._slice(flat)
        if isinstance(self.state, AdamWState):
            moments = ck.restore(step, ADAMW_FILE)
            self._check_like(step, "AdamW moments", [moments["mu"], moments["nu"]],
                             [self.state.mu, self.state.nu])
            with torch.no_grad():
                self.flat.params.copy_(flat)
                self.state.mu.copy_(moments["mu"])
                self.state.nu.copy_(moments["nu"])
            self.state = AdamWState(state["count"].to(self.device), self.state.mu,
                                    self.state.nu)
            self._restored_counters(state)
            return
        if isinstance(self.state, Zero1State):
            chunks = ck.restore(step, zero1_file(self.rank))
            self._check_like(step, "ZeRO-1 moment chunks", [chunks["m"], chunks["v"]],
                             [self.state.m, self.state.v])
            with torch.no_grad():
                self.flat.params.copy_(flat)
                self.state.m.copy_(chunks["m"])
                self.state.v.copy_(chunks["v"])
            self.state = Zero1State(state["count"].to(self.device), self.state.m, self.state.v)
            self._restored_counters(state)
            return
        # the checkpoint's health mask (a guard on when it was written)
        health = state.get("health") if meta.get("has_guard", "health" in state) else None
        if ckpt_world == self.world:
            mom = self._slice(ck.restore(step, momentum_file(self.rank, self._stage)))
        else:
            rows = torch.stack([ck.restore(step, momentum_file(r, self._stage))
                                for r in range(ckpt_world)])
            sick = [] if health is None else torch.nonzero(~health).flatten().tolist()
            if sick:
                # only healthy momenta enter the remap: the quarantined rows
                # restart at the healthy mean first (JAX loop.py:2185-2198)
                rows = heal_worker_momentum(rows, health, sick)
                self._emit(f"[trainer] elastic resume: healed quarantined worker momenta "
                           f"{sick} from the healthy mean before the world remap")
            mom = self._slice(remap_worker_momentum(rows, ckpt_world, self.world)[self.rank])
        self._check_like(step, "momentum", [mom], [self.state.exp_avg])
        guard = {"health": None, "prev_ballot": None}
        if self._guard is not None:
            # worker identity does not survive a world change, and a
            # checkpoint without guard state gets a fresh one
            guard = fresh_guard_state(self.n_params, cfg.vote_every or 1, self.world,
                                      self.device)
            if ckpt_world == self.world and health is not None:
                prev = ck.restore(step, prev_ballot_file(self.rank))
                self._check_like(step, "guard health mask and previous ballot",
                                 [health, prev], list(guard.values()))
                guard = {"health": health.to(self.device), "prev_ballot": prev.to(self.device)}
        elected = None
        if self.state.elected is not None:
            elected = state.get("elected")
            if elected is None:
                raise ValueError(f"checkpoint step {step} holds no elected-sign cache")
            self._check_like(step, "elected-sign cache", [elected], [self.state.elected])
        ring = None
        if self.state.dcn_ring is not None:  # the same world: an elastic resume refused it
            ring = ck.restore(step, ring_file(
                self.rank, self.tensor.rank if self.tensor.size > 1 else None,
                self.expert.rank if self.expert.size > 1 else None, self._stage))
            self._check_like(step, "DCN ring", [ring], [self.state.dcn_ring])
            ring = ring.to(self.device)
        moe_ring = None
        if self.state.moe_ring is not None:  # the same world and depth (refused otherwise)
            moe_ring = ck.restore(step, moe_ring_file(self.rank))
            self._check_like(step, "MoE balance ring", [moe_ring], [self.state.moe_ring])
            moe_ring = moe_ring.to(self.device)
        vh = None
        ckpt_ve = int(meta.get("vote_every", cfg.vote_every or 1) or 1)
        if (ckpt_world == self.world and self.vote_health is not None
                and ckpt_ve == (cfg.vote_every or 1) and ck.exists(step, VOTE_HEALTH_FILE)):
            # adopted only while its packing matches this run; otherwise
            # the telemetry window restarts fresh
            vh = telemetry.VoteHealth(**ck.restore(step, VOTE_HEALTH_FILE,
                                                   map_location=self.device))
        with torch.no_grad():
            self.flat.params.copy_(flat)
            self.state.exp_avg.copy_(mom)
        self.state = LionState(state["count"].to(self.device), self.state.exp_avg,
                               int(state["steps"]),
                               None if elected is None else elected.to(self.device), **guard,
                               dcn_ring=ring, moe_ring=moe_ring)
        self.opt.seed = state["seed"]  # the stochastic draws', as JAX restores its key
        if self._guard is not None:
            mask = guard["health"].cpu().numpy()
            if self._cplane is not None and ckpt_world == self.world and health is not None:
                # the plane's meta (a plane-off checkpoint has none: its
                # masked ranks resume quarantined, nobody departed)
                self._cplane.adopt(mask, step, departed=meta.get("cp_departed"),
                                   sched_through=meta.get("cp_sched_through"),
                                   rejoining_until=meta.get("cp_rejoining_until"),
                                   quarantine_counts=meta.get("cp_quarantine_counts"))
                if not mask.all():
                    lc = self._cplane.lifecycle()
                    self._emit("[trainer] control plane: resumed with lifecycle "
                               f"{dict((w, s) for w, s in enumerate(lc) if s != 'healthy')} "
                               f"at step {step}")
            else:
                self._guard.adopt_mask(mask, step)  # quarantined ranks restart their cooldown
                if not mask.all():
                    self._emit(f"[trainer] vote guard: resumed with quarantined workers "
                               f"{np.nonzero(~mask)[0].tolist()} (cooldown restarts at step "
                               f"{step})")
        if vh is not None:
            self.vote_health = vh
        if ckpt_world != self.world:
            self._emit(f"[trainer] elastic resume: remapped the momenta of {ckpt_world} ranks "
                       f"to {self.world} ({'group mean' if ckpt_world > self.world else 'replicate'}"
                       " policy, cross-rank mean kept)")
        self._restored_counters(state)

    @staticmethod
    def _check_like(step: int, what: str, got: list, want: list) -> None:
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise ValueError(f"checkpoint step {step}: {what} {tuple(g.shape)} {g.dtype}, "
                                 f"expected {tuple(w.shape)} {w.dtype}")

    def _restored_counters(self, state: dict) -> None:
        self.step_count = int(state["step"])
        self._resume_skip_batches = int(state.get("batches_consumed", state["step"]))

    def _maybe_resume(self) -> None:
        """Resume from the newest checkpoint that verifies and restores on
        every rank; rank 0 verifies and tells the others."""
        ck, cfg = self.checkpointer, self.cfg
        if not (ck and cfg.resume_from_checkpoint):
            return
        found = [None, None]
        if self.chief:
            cands = (ck.valid_steps() if cfg.ckpt_integrity
                     else [s for s in [ck.latest_step()] if s is not None])
            found = [cands, {s: (ck.manifest_meta(s) if cfg.ckpt_integrity else None) or {}
                             for s in cands}]
        every = self.grid.world   # every process of the run agrees
        many = every is not None and dist.get_world_size(every) > 1
        if many:
            dist.broadcast_object_list(found, src=dist.get_global_rank(every, 0), group=every)
        candidates, metas = found
        for step in candidates:
            meta = metas[step]
            ckpt_world = int(meta.get("world", self.world))
            if meta:
                check_resume_meta(step, meta, cfg, self.tensor.size, self.expert.size,
                                  self.pipe.size)
            ckpt_ve = int(meta.get("vote_every", 0) or 0)  # 0: not recorded
            if cfg.lion and ckpt_ve and ckpt_ve != (cfg.vote_every or 1):
                raise ValueError(
                    f"checkpoint step {step} was written at --vote_every {ckpt_ve}, this run "
                    f"has --vote_every {cfg.vote_every or 1}: the elected-sign cache's layout "
                    "does not survive a change of vote_every (resume with the same value, or "
                    "start fresh)")
            if ckpt_world != self.world and not cfg.elastic_resume:
                raise ValueError(
                    f"checkpoint step {step} holds momenta for world={ckpt_world} but this run "
                    f"has world={self.world}; pass --elastic_resume to remap them (or match "
                    "the rank count)")
            if ckpt_world != self.world and not cfg.lion:
                raise NotImplementedError(
                    "--elastic_resume remaps the stacked per-worker "
                    "Lion momenta; the AdamW/ZeRO-1 states have no "
                    "defined remap")
            if ckpt_world != self.world and cfg.dcn_pipeline_depth > 0:
                raise NotImplementedError(
                    "--elastic_resume cannot remap the DCN pipeline "
                    "ring: its slots are in-flight level-2 tallies "
                    "whose chunk ownership and group count are "
                    "functions of the world size. Resume at the "
                    "original world (drain the pipeline), or restart "
                    "with --dcn_pipeline_depth 0")
            if ckpt_world != self.world and (cfg.ep_dcn_pipeline or 0) > 0:
                raise NotImplementedError(
                    "--elastic_resume cannot remap the MoE balance "
                    "ring: its rows are per-data-worker stale tallies "
                    "of batches the new world never routed. Resume at "
                    "the original world, or restart with "
                    "--ep_dcn_pipeline 0")
            error = None
            try:
                self._restore_step(step, meta, ckpt_world)
            except Exception as e:
                error = e
            ok = torch.tensor([0 if error else 1], dtype=torch.int32, device=self.device)
            if many:
                dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=every)
            if not int(ok):
                self._emit(f"[trainer] checkpoint step {step} failed to restore "
                           f"({error or 'on another rank'}); falling back to the previous good "
                           "checkpoint")
                continue
            purged = ck.purge_steps_after(step)
            if purged:
                self._emit(f"[trainer] purged stale newer checkpoints {purged}")
            self._emit(f"[trainer] resumed from checkpoint step {step}")
            return
        if candidates:
            raise RuntimeError(
                f"resume_from_checkpoint: all {len(candidates)} verified checkpoint(s) (steps "
                f"{candidates}) failed to restore into this run's state: likely a model or "
                "optimizer config change since they were written"
                + (f" (this run's --dcn_pipeline_depth {cfg.dcn_pipeline_depth} is one "
                   "candidate: a checkpoint without manifest meta cannot be depth-checked up "
                   "front, and the DCN ring does not survive a depth change)"
                   if cfg.dcn_pipeline_depth > 0 else "")
                + ". Refusing to silently "
                "restart from step 0; pass --resume_from_checkpoint false (or point "
                "--output_dir elsewhere) to start fresh")

    def close(self) -> None:
        self.profiler.close()
        if self._preempt is not None:
            self._preempt.close()
        if self.cfg.inject_poison:
            # a later trainer in this process does not inherit the sick rank
            resilience.inject_fault("ballot_poison", None)
        if self.cfg.inject_membership:
            # nor the unconsumed rest of the membership schedule
            resilience.inject_fault("membership", None)
        try:
            if self.checkpointer:
                # may raise a failure of the commit thread; the metrics log
                # still closes
                self.checkpointer.close()
        finally:
            self.logger.close()
            # the journal closes last: the drain above still records its
            # spans, and a failure raised here leaves a flushed journal
            journal.uninstall(self.journal)
            self.journal.close()
