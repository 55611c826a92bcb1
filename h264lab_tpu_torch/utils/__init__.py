"""Device selection, synthetic test input, YUV file I/O and PSNR
metrics."""
