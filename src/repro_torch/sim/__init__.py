"""The offloading simulator of the port: the cost model, MIOBench and
CEMLLM-Sim (numpy-only copies of ``repro/sim``)."""
