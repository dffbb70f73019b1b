"""Int8 absmax quantize/dequantize: plain versions and kernel wrappers."""
