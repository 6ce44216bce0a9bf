"""One driver a kind of traffic: ``traffic/<mix>.json`` names its ``kind``,
and ``drivers/<kind>.py`` holds ``Cell``, which sets the cell up, runs its
window and checks what the window produced, ``FAULTS``, the faults its
check must catch, and ``substitute``, which plants them or the control
underneath the timed path (``benchmark/faults.py``)."""
