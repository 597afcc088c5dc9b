"""The MineDojo action-table constants the DreamerV3 player's action masks
read (copied from ``sheeprl_tpu/envs/minedojo.py``).

The agent sees a 3-branch multi-discrete action ``[compound_action,
craft_item, inventory_item]``: compound actions 0-11 are movement and
camera, always legal; 12-18 are the functional actions ``FN_USE`` ..
``FN_DESTROY``, compound index ``N_MOVEMENT_ACTIONS + fn - 1``.  The suite
itself needs the ``minedojo`` package, which neither machine the port runs
on has: ``env.wrapper.kind=minedojo`` raises (ROADMAP.md, queue A item 2).
"""

# functional-action slot values in the backend action vector
FN_NOOP, FN_USE, FN_DROP, FN_ATTACK, FN_CRAFT, FN_EQUIP, FN_PLACE, FN_DESTROY = range(8)
N_MOVEMENT_ACTIONS = 12  # actions 0-11 are always legal
#: the mask observations, in the order the player reads them
MASK_KEYS = ("mask_action_type", "mask_craft_smelt", "mask_equip_place", "mask_destroy")
