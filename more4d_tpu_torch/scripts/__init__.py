"""Command-line entry points of the port, the counterparts of the JAX
package's ``scripts/``: ``python -m more4d_tpu_torch.scripts.<name>``.

- ``infer``: single image -> 4D novel-view videos from released-layout
  checkpoints (``scripts/infer.py``);
- ``infer_vae``: the trajectory adaptors' round trip through the VAE
  (``scripts/infer_vae.py``);
- ``check_wan``, ``check_unidepth``: first-contact checks of a released
  checkpoint's keys and shapes (``scripts/check_*.py``).
"""
