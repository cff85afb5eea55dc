"""The bound deployment graph that tests/test_torch_serve_config.py
deploys by import_path: the port's copy of tests/serve_test_app.py. It
imports nothing of the JAX package, since the port's replica workers
import it."""

from ray_tpu_torch import serve


@serve.deployment
class Doubler:
    def __call__(self, x):
        return x * 2


@serve.deployment
class Pipeline:
    def __init__(self, doubler):
        self.doubler = doubler

    def __call__(self, payload):
        v = payload["v"] if isinstance(payload, dict) else payload
        return self.doubler.remote(v).result(timeout=30) + 1


app = Pipeline.bind(Doubler.bind())
