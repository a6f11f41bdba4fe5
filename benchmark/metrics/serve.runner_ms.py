"""serve.runner_ms: mean host time of a runner call in the window (upload,
forward, read-back), from the benchmark's span around it."""

from benchmark.readers import mean_ms


def read(obs):
    return mean_ms(obs.get('runner_s', []))
