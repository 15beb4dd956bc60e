"""Models built with the port's fluid layers, after paddle_tpu/models/."""
