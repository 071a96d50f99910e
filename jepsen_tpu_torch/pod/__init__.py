"""Processes of the port: the fleet half of jepsen_tpu.pod.launcher.

``launcher.py`` spawns checker-daemon fleet members as fresh
interpreters and waits for them to announce. The reference's pod layer
(``topology``, ``faultdomains``, ``slicing`` and ``launch_pod``: a
multi-process mesh) is not ported yet.
"""
