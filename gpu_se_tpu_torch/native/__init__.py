"""The float64 serial particle-filter engine (``serial``), C++ bound with
ctypes: the oracle of the card's float32 filter steps."""
