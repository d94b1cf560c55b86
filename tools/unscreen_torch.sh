#!/bin/bash
# Launcher of the PyTorch port's CLIs, in tools/unscreen.sh's argument order:
#   bash tools/unscreen_torch.sh <green|bg|bg_offline> <src_video_id> <device_id> [extra args]
# <device_id> picks the card (UNSCREEN_DEVICE_ID); extra args go to
# tools/unscreen/<script>_torch.py (for example --fused --wire yuv420,
# --stages 2,3 for bg_offline, or --device cpu).

script=$1
src=$2
dev_id=$3
PY_ARGS=${@:4}
echo "unscreen video ${src} on device ${dev_id}"

if [ -z "${dev_id}" ]; then
    echo "Device not set. Using default device 0"
    dev_id="0"
fi

UNSCREEN_DEVICE_ID=${dev_id} python tools/unscreen/${script}_torch.py --video_id ${src} ${PY_ARGS}
echo "finished video ${src} on device ${dev_id}"
