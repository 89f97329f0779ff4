"""Control-plane application of the port (reference: ``lumen-app``,
SURVEY.md §2.7): ``python -m lumen_tpu_torch.app.main --port 8000``.

A local web app that walks a user from bare machine to running inference
server: hardware detection -> config generation -> environment install ->
server supervision, over REST (``/api/v1/{config,hardware,install,server}``)
plus a WebSocket log stream (``/ws/logs``). The JAX package's app, copied
(same routes, bodies and web assets), with its hardware half rewritten
for NVIDIA cards:
- presets describe a CUDA card (one H100) or the CPU, and each generated
  service block states its device;
- detection asks torch in a subprocess (the app never holds a CUDA
  context), with ``nvidia-smi`` as the fallback;
- the environment check asks for torch built for CUDA, ``nvcc`` (the
  kernels build at first use), the driver and ``/dev/nvidia*``;
- the installer verifies torch and the port, and the supervised server is
  the port's (``lumen_tpu_torch.serving.server``).
"""

from lumen_tpu_torch.app.state import AppState

__all__ = ["AppState"]
