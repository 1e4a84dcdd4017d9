"""The operations a traffic mix drives, one module each, found by the
`op` of the traffic file: each has ``prepare`` (the inputs of the window
from the pool's texts, made at set-up), ``run`` (one call of the program
on one input: its output and the program's phase seconds), ``expected``
(the plain reference's answer for one text) and ``compare`` (the numbers
that decide `correct`, each with its limit), and the configuration and
traffic keys it acts on (``CONFIG_KEYS``, ``TRAFFIC_KEYS``, ``FIXED``)."""
