"""The runners of the traffic kinds: a traffic file's ``kind`` names the
module ``kinds/<kind>.py``, whose ``Cell`` runs it."""
