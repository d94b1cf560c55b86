#!/bin/bash
# Launcher of the PyTorch port's person replacement, in tools/replace.sh's
# argument order:
#   bash tools/replace_torch.sh replace <src> [extra args]
# extra args go to tools/replace/<script>_torch.py (for example
# --harmonize, --data_root DIR or --device cpu).
script=$1
src=$2
PY_ARGS=${@:3}
python tools/replace/${script}_torch.py --src ${src} ${PY_ARGS}
