"""The calibration fitter's command line:

    python -m stateright_tpu_torch.obs.calibrate ROOT [--device KIND] [--ridge R] [--out PATH]

fits the cost model's rates to the observation records under ROOT (what the
engines' comparators flush there with SR_TPU_CALIB_DIR=ROOT) and prints
obs/calib.py `calibrate`'s report: the stock against the fitted rates, the
leave-one-key-out holdout, the overlay file written (activate it with
SR_TPU_COSTMODEL_CALIB), and the dedup ranking under the fitted rates."""

import sys

from .calib import main

if __name__ == "__main__":
    sys.exit(main())
