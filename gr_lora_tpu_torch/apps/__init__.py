"""Application entry points — the reference examples/*.grc flowgraphs as
CLIs: rx_file, rx_file_collision, tx_file, txrx_sim, rx_stream and the
product gateway (see each module).  Each ``main(argv=None,
device="cuda")`` runs on the card unless a caller passes ``device``."""
