"""The paper's offloading policies in the port: so far only the heuristic
baselines (``core/baselines.py``); the learning pipeline (QLMIO, MGQP,
MILP, D3QN) comes with ROADMAP queue 1 item 7."""
