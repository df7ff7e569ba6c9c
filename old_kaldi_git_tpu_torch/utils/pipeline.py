"""Stage-gated pipeline driver with artifact-based resume.

Counterpart of old_kaldi_git_tpu/utils/pipeline.py (the reference scripts'
`if [ $stage -le N ]` gates with `--stage N` resume, idempotent by
artifact):

    pipe = Pipeline("exp/tri3b", stage=args.stage)

    @pipe.stage(10, "train mono", produces="mono/final.mdl")
    def _(ctx):
        model.save(ctx.path("mono/final.mdl"))

    pipe.run()

* stages run in ascending number order; stages below `stage` are skipped;
* a stage whose `produces` artifacts all exist is skipped;
* with `log_to_files`, each stage logs to <dir>/log/<number>.<slug>.log;
* stages share state through the `ctx` object (attribute bag + path helper);
  `ctx.stage_seconds` holds the host-clock seconds of each stage that ran.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, Dict, List, Sequence, Tuple, Union

from old_kaldi_git_tpu_torch.utils.log import _ROOT, get_logger

log = get_logger("pipeline")


class PipelineContext:
    """Attribute bag shared across stages + workdir path helper."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        self.stage_seconds: Dict[int, float] = {}

    def path(self, *parts: str) -> str:
        p = os.path.join(self.workdir, *parts)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        return p


class Pipeline:
    def __init__(self, workdir: str, stage: int = 0, log_to_files: bool = True):
        self.workdir = workdir
        self.start_stage = stage
        self.log_to_files = log_to_files
        self.ctx = PipelineContext(workdir)
        self._stages: List[Tuple[int, str, Tuple[str, ...], Callable]] = []
        os.makedirs(os.path.join(workdir, "log"), exist_ok=True)

    def stage(self, number: int, name: str, produces: Union[str, Sequence[str]] = ()):
        """Register a stage; `produces` paths (relative to the workdir) make
        the stage skippable when they all exist."""
        if isinstance(produces, str):
            produces = (produces,)

        def reg(fn: Callable):
            self._stages.append((number, name, tuple(produces), fn))
            return fn

        return reg

    def run(self) -> PipelineContext:
        self._stages.sort(key=lambda s: s[0])
        for number, name, produces, fn in self._stages:
            if number < self.start_stage:
                log.info("stage %d (%s): skipped (--stage %d)", number, name,
                         self.start_stage)
                continue
            if produces and all(os.path.exists(os.path.join(self.workdir, p))
                                for p in produces):
                log.info("stage %d (%s): artifacts present, skipping", number, name)
                continue
            log.info("stage %d (%s): running", number, name)
            t0 = time.time()
            if self.log_to_files:
                slug = name.replace(" ", "_")
                logpath = os.path.join(self.workdir, "log", f"{number}.{slug}.log")
                with open(logpath, "a") as lf:
                    lf.write(f"# stage {number} ({name}) started {time.strftime('%F %T')}\n")
                    lf.flush()
                    # the stage's stdout, stderr and logging into its log: the
                    # port's loggers do not propagate, so the handler goes on
                    # their root as well as on the root logger
                    handler = logging.StreamHandler(lf)
                    handler.setFormatter(logging.Formatter("%(levelname).1s %(message)s"))
                    loggers = (logging.getLogger(), logging.getLogger(_ROOT))
                    for lg in loggers:
                        lg.addHandler(handler)
                    try:
                        with contextlib.redirect_stdout(lf), contextlib.redirect_stderr(lf):
                            fn(self.ctx)
                    finally:
                        for lg in loggers:
                            lg.removeHandler(handler)
                    lf.write(f"# done in {time.time() - t0:.1f}s\n")
            else:
                fn(self.ctx)
            self.ctx.stage_seconds[number] = time.time() - t0
            log.info("stage %d (%s): done in %.1fs", number, name, time.time() - t0)
        return self.ctx
