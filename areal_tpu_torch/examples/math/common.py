"""Shared helpers of the math entries (``gsm8k_rl``, ``gsm8k_sft``,
``gsm8k_eval``) — the port of ``examples/math/common.py``: tokenizer and
processor loading, the reward and workflow for a dataset type, and the
single-host stack (the trainer engine, then an in-process server from its
weights)."""

from __future__ import annotations

import contextlib
import os
import signal

from areal_tpu_torch.reward.gsm8k import gsm8k_reward_fn

VISION_DATASETS = ("clevr_count_70k", "geometry3k", "virl39k")


TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model", "vocab.json")


def load_tokenizer(path: str):
    """A tokenizer from ``path``, or None: weights-only and from-scratch
    model directories have no tokenizer files (a directory without one is
    not handed to ``transformers``, whose import alone takes seconds), and
    the card's hosts may have no ``transformers``; the entries then use the
    rows' char-level ``prompt_ids``."""
    if not path:
        return None
    if os.path.isdir(path) and not any(os.path.exists(os.path.join(path, f)) for f in TOKENIZER_FILES):
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(path)
    except Exception as e:  # noqa: BLE001 — any failure means "no tokenizer"
        print(f"warning: no tokenizer at {path} ({e}); continuing without one")
        return None


def reward_for(dataset_type: str):
    if dataset_type == "synthetic_arith":
        from areal_tpu_torch.reward.synthetic import arith_char_reward_fn

        return arith_char_reward_fn
    if dataset_type == "countdown":
        from areal_tpu_torch.reward.countdown import countdown_reward_fn

        return countdown_reward_fn
    if dataset_type == "clevr_count_70k":
        from areal_tpu_torch.reward.clevr_count import clevr_count_reward_fn

        return clevr_count_reward_fn
    if dataset_type in ("geometry3k", "virl39k"):
        from areal_tpu_torch.reward.math_verify import math_verify_reward_fn

        return math_verify_reward_fn
    return gsm8k_reward_fn


def make_workflow(dataset_type: str, gconfig, tokenizer, processor=None):
    """RLVR for text datasets; ``VisionRLVRWorkflow`` (pixel patches on the
    request path) for image datasets."""
    reward_fn = reward_for(dataset_type)
    if dataset_type in VISION_DATASETS:
        from areal_tpu_torch.workflow.vision_rlvr import VisionRLVRWorkflow

        if processor is None:
            raise ValueError(f"{dataset_type} needs an image processor (AutoProcessor of the VLM checkpoint)")
        return VisionRLVRWorkflow(reward_fn, gconfig, tokenizer, processor)
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    return RLVRWorkflow(reward_fn, gconfig, tokenizer=tokenizer)


def load_processor(path: str, dataset_type: str = ""):
    """AutoProcessor of a VLM checkpoint, only for a dataset with images;
    None otherwise or when it does not load."""
    if not path or dataset_type not in VISION_DATASETS:
        return None
    try:
        from transformers import AutoProcessor

        return AutoProcessor.from_pretrained(path)
    except Exception as e:  # noqa: BLE001 — the vision workflow refuses to build without one
        print(f"warning: AutoProcessor load failed at {path}: {e}")
        return None


@contextlib.contextmanager
def kept_signal_handlers():
    """Restore SIGTERM's, SIGUSR1's and SIGUSR2's handlers on the way out:
    an entry run in process (a test, a script driving several) leaves the
    server's flight dump and the trainer's preemption and profile handlers
    behind otherwise, even when it raises."""
    sigs = [s for s in (signal.SIGTERM, getattr(signal, "SIGUSR1", None), getattr(signal, "SIGUSR2", None))
            if s is not None]
    saved = {s: signal.getsignal(s) for s in sigs}
    try:
        yield
    finally:
        for s, h in saved.items():
            try:
                signal.signal(s, h if h is not None else signal.SIG_DFL)
            except ValueError:  # off the main thread nothing was installed either
                pass


def start_single_host_stack(config, dataset_size: int, device=None):
    """The single-host RL stack: the trainer engine first, then an
    in-process server started from its weights. Updates are "mem" pushes
    (bf16 buckets over HTTP). The server serves on the gen half's mesh
    (``allocation_mode``'s ``tN``: N cards from ``device`` on). Returns
    (actor_engine, server)."""
    from areal_tpu_torch.api.alloc_mode import apply_allocation_mode
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine

    apply_allocation_mode(config)  # the halves' meshes, the server's included
    config.weight_update_mode = "mem"
    config.actor.temperature = config.gconfig.temperature
    actor_engine = TorchTrainEngine(config.actor, device=device)
    actor_engine.initialize(
        FinetuneSpec(
            total_train_epochs=config.total_train_epochs,
            dataset_size=dataset_size,
            train_batch_size=config.train_dataset.batch_size,
        ),
        seed=config.seed,
    )
    scfg = config.server
    scfg.model_path = scfg.model_path or config.actor.path
    # the server holds its own copy at the compute dtype: a model handed to
    # DecodeEngine is served in place, and the trainer's holds the f32
    # master weights the pushes are cast from
    server = start_local_server(
        scfg, params=actor_engine.model.state_dict(), model_cfg=actor_engine.model_cfg, device=device
    )
    return actor_engine, server


def start_local_server(server_cfg, params=None, model_cfg=None, device=None):
    """An in-process ``DecodeEngine`` and HTTP server on this host's card,
    or on ``server_cfg.mesh.model`` cards from ``device`` on. With
    ``params`` it serves them; otherwise it loads ``server_cfg.model_path``."""
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread

    engine = DecodeEngine(server_cfg, params=params, model_cfg=model_cfg, device=device)
    engine.initialize()
    server = ServerThread(server_cfg, engine)
    server.start()
    return server
