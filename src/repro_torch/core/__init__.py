"""The paper's primary contribution in the port: QLMIO + MGQP + MILP (+
baselines): the frozen encoders and the feature store, the extractor, the
MGQP/MILP predictors, the D3QN agent, the QLMIO harness and the
heuristic and learning baselines."""
from repro_torch.core.d3qn import D3QNAgent, D3QNConfig  # noqa: F401
from repro_torch.core.predictors import Predictor, PredictorConfig  # noqa: F401
from repro_torch.core.qlmio import QLMIO, QLMIOConfig  # noqa: F401
