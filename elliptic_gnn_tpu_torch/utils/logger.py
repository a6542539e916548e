"""Run logging: training_log.csv + optional TensorBoard scalars.

Counterpart of elliptic_gnn_tpu/utils/logger.py: a CSV with
(epoch, train_loss, val_pr_auc) rows and TB scalars `loss/train`,
`val/pr_auc_illicit`, held open for the whole run.
"""
from __future__ import annotations

import csv
import os
from typing import Optional


class RunLogger:
    def __init__(self, outdir: str, tensorboard: bool = True):
        os.makedirs(outdir, exist_ok=True)
        self.csv_path = os.path.join(outdir, "training_log.csv")
        new_file = not os.path.exists(self.csv_path)
        self._fh = open(self.csv_path, "a", newline="")
        self._csv = csv.writer(self._fh)
        if new_file:
            self._csv.writerow(["epoch", "train_loss", "val_pr_auc"])
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(outdir, "tb"))
            except Exception:  # tensorboard is optional: CSV-only logging
                self._tb = None

    def log_epoch(self, epoch: int, train_loss: float, val_pr_auc: float,
                  extras: Optional[dict] = None) -> None:
        self._csv.writerow([epoch, f"{train_loss:.6f}", f"{val_pr_auc:.6f}"])
        self._fh.flush()
        if self._tb is not None:
            self._tb.add_scalar("loss/train", train_loss, epoch)
            self._tb.add_scalar("val/pr_auc_illicit", val_pr_auc, epoch)
            if extras:
                for k, v in extras.items():
                    self._tb.add_scalar(k, v, epoch)

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """RunLogger's interface, doing nothing: the logger of every rank but
    the primary one, which alone writes the run dir
    (parallel/multihost.py)."""

    def log_epoch(self, epoch: int, train_loss: float, val_pr_auc: float,
                  extras: Optional[dict] = None) -> None:
        pass

    def close(self) -> None:
        pass
