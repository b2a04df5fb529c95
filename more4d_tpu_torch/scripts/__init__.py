"""Command-line entry points of the port, the counterparts of the JAX
package's ``scripts/``: ``python -m more4d_tpu_torch.scripts.<name>``.

- ``infer``: single image -> 4D novel-view videos from released-layout
  checkpoints (``scripts/infer.py``);
- ``infer_vae``: the trajectory adaptors' round trip through the VAE
  (``scripts/infer_vae.py``);
- ``train_vism``: the 4D-ViSM LoRA trainer (``scripts/train_vism.py``),
  resident or with the base's blocks streamed from host memory;
- ``train_vae``: the VAE trajectory-adaptor trainer
  (``scripts/train_vae.py``);
- ``check_wan``, ``check_unidepth``: first-contact checks of a released
  checkpoint's keys and shapes (``scripts/check_*.py``).
"""
