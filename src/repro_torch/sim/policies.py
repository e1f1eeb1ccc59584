"""fig10's idealized predictors and its QLMIO scoring rule (a copy of
``benchmarks/fig10_continuum_replay.py:62-86``, numpy only, so that the
port imports nothing of the JAX package or of ``benchmarks/``).  The
continuum replay over live engines uses them: ``examples/
pt_serve_continuum.py`` and ``chip_smoke.py`` phase 9d."""
from __future__ import annotations

import numpy as np

from repro_torch.data.taskgen import CATEGORIES
from repro_torch.sim import cost_model as cm
from repro_torch.sim.miobench import SERVER_CLASSES


def analytic_predictors(bench):
    """Idealized MILP/MGQP: the cost model evaluated without noise,
    [n_tasks, n_classes] latency estimates and success probabilities."""
    C = len(SERVER_CLASSES)
    aff = cm.category_affinity(len(CATEGORIES), C)
    t_hat = np.zeros((bench.tasks.n, C))
    b_hat = np.zeros((bench.tasks.n, C))
    for c, (dev, mdl) in enumerate(SERVER_CLASSES):
        t_hat[:, c] = cm.latency_s(cm.DEVICES[dev], cm.MODELS[mdl],
                                   bench.tasks.text_len,
                                   bench.tasks.difficulty)
        b_hat[:, c] = cm.success_prob(cm.MODELS[mdl], bench.tasks.difficulty,
                                      aff[bench.tasks.category, c])
    return t_hat, b_hat


def qlmio_policy(t_hat, b_hat, servers, w):
    """The QLMIO scoring rule (router Eq. 21 shape) over episode state, at
    quality weight ``w``."""
    cls = servers.cls

    def policy(ep):
        total = t_hat[ep.current_task, cls] + ep.queue_s
        u = -total / max(total.min(), 1e-6) + w * (
            3.0 * b_hat[ep.current_task, cls] - 2.0)
        return int(np.argmax(u))

    return policy
