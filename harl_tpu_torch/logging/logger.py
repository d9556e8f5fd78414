"""Training observability: console, TensorBoard, progress file (counterpart
of ``harl_tpu/logging/logger.py``; reference ``harl/common/base_logger.py``).

Stdout episode summaries with FPS, scalars to TensorBoard when its writer
imports, and an append-only ``progress.txt`` of one JSON record a line,
which does not depend on TensorBoard. Evaluations are appended there too,
as records with ``steps`` and ``eval_*`` keys.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class TrainLogger:
    def __init__(self, args, algo_args, env_args, num_agents, log_dir: Optional[str] = None):
        self.args = args
        self.algo_args = algo_args
        self.env_args = env_args
        self.num_agents = num_agents
        self.log_dir = log_dir
        self.start = time.time()
        self.writer = None
        self.progress_file = None
        if log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.writer = SummaryWriter(log_dir)
            self.progress_file = open(os.path.join(log_dir, "progress.txt"), "a")

    def _append(self, record: Dict) -> None:
        if self.progress_file is not None:
            self.progress_file.write(json.dumps(record, default=float) + "\n")
            self.progress_file.flush()

    def log_episode(self, record: Dict) -> None:
        """record: episode, steps, mean_episode_return, value_loss (or
        critic_loss), fps, and optional per-agent stats and env metrics."""
        steps = record.get("steps", 0)
        total = self.algo_args["train"]["num_env_steps"]
        print(
            f"[{self.args.get('algo', '?')} | {self.args.get('env', '?')}] "
            f"steps {steps}/{total} "
            f"return {record.get('mean_episode_return', float('nan')):.2f} "
            f"value_loss {record.get('value_loss', record.get('critic_loss', float('nan'))):.4f} "
            f"FPS {record.get('fps', 0):.0f}",
            flush=True,
        )
        if self.writer is not None:
            for k, v in record.items():
                if isinstance(v, (int, float)):
                    self.writer.add_scalar(k, v, steps)
            for i, stats in enumerate(record.get("agent_stats", [])):
                for k, v in stats.items():
                    self.writer.add_scalar(f"agent{i}/{k}", v, steps)
        self._append(record)

    def log_eval(self, steps: int, mean_return: float, extra: Optional[Dict] = None) -> None:
        extra = extra or {}
        extra_txt = "".join(f" {k}={v:.3f}" for k, v in extra.items())
        print(f"  eval @ {steps}: return {mean_return:.2f}{extra_txt}", flush=True)
        if self.writer is not None:
            self.writer.add_scalar("eval_return", mean_return, steps)
            for k, v in extra.items():
                self.writer.add_scalar(f"eval_{k}", v, steps)
        self._append({"steps": steps, "eval_return": mean_return,
                      **{"eval_win_rate" if k == "won" else f"eval_{k}": v
                         for k, v in extra.items()}})

    def close(self) -> None:
        if self.writer is not None:
            self.writer.flush()
            self.writer.close()
        if self.progress_file is not None:
            self.progress_file.close()
