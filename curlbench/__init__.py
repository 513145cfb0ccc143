"""curlbench: the benchmark of curl_tpu_torch on the NVIDIA H100 (see README.md)."""
