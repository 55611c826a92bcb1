"""Independent numpy H.264 baseline decoder (both SVC layers), the port's
copy of `h264lab_tpu/decoder`: it runs on the host, with no jax, and
decodes the streams the card writes bit-exactly to their reconstruction."""
