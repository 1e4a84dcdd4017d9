"""Host-only container and file tools: transcode (v1 <-> QVZ2), mse_check
and fastq, each with a ``python -m qvz_tpu_torch.tools.<name>`` entry."""
