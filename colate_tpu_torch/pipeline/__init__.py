"""Host-to-device stages of the port (colate_tpu/pipeline counterparts)."""
