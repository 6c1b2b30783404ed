"""Running a cell of the benchmark in this process on the CPU, at sizes a
test can hold."""
import contextlib
import io
import json

TINY_DECODER = {"name": "olmo-tiny", "family": "dense", "num_layers": 2,
                "d_model": 64, "d_ff": 128, "vocab_size": 256,
                "num_heads": 4, "num_kv_heads": 4, "head_dim": 16,
                "norm": "nonparam_ln", "rope_theta": 10000.0,
                "tie_embeddings": True, "param_dtype": "float32", "compute_dtype": "float32",
                "q_chunk": 16, "kv_chunk": 16, "loss_chunk": 16}

SIZES = {
    "olmo-1b-ec8.train": {"model": TINY_DECODER, "batch": 4, "seq_len": 32,
                          "batch_pool": 4},
    "fig6-msr-d10.repair-b1": {"block_bytes": 4096,
                               "judge": {"plans": 3, "columns": 256}},
    "fig6-msr-d10.plan-bulk": {"batch": 32,
                               "judge": {"plans": 3, "columns": 256}},
}

# The window of each cell's CPU run: the repair cell's p95 needs at least
# two repairs in it, beside the suite's other workers.
SECONDS = {"fig6-msr-d10.repair-b1": 4.0}


def run_cell(cell, seed=2147483701, seconds=None, trace=0, fault=None):
    """(exit code, the last line parsed or None, standard error).  The
    check for JAX and the JAX package counts only what the run itself
    loaded: the suite's other files, in the same worker, load both."""
    import sys
    from unittest import mock
    from perfbench import run
    before = set(sys.modules)
    found = run.forbidden_modules
    sizes = json.loads(json.dumps(SIZES[cell]))
    seconds = SECONDS.get(cell, 1.0) if seconds is None else seconds
    out, err = io.StringIO(), io.StringIO()
    with (fault() if fault else contextlib.nullcontext()), \
            mock.patch.object(run, "forbidden_modules", lambda: [
                m for m in found() if m not in before]), \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace), "--device",
                       "cpu"], overrides=sizes)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
