"""Host-side rendering (counterpart of vmas_tpu/render/): the viewer
(``viewer.render_env``, behind ``Environment.render``), the drawing helpers
of the scenarios' render hooks (``draw``), ``video.save_video`` and
interactive play (``interactive``). matplotlib is imported inside the
functions that draw, so importing the package needs none."""
