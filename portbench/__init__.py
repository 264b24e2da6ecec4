"""The benchmark of ``vmas_tpu_torch`` on an NVIDIA GPU: ``python -m portbench
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` from the root of a
checkout (see ``portbench/README.md``)."""
