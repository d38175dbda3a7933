// The slot dtype of a fold's batch, shared by csrc/groupby.cu and
// csrc/sharded.cu. Slots go up as uint16 while the capacity is at most
// 65,535, else int32 (ekuiper_tpu_torch/ops/groupby.py slot_dtype), and a
// sliding refold's cache may hold both, so every fold kernel is templated
// on the slot type and instantiated once per dtype.
#pragma once

#include <stdint.h>

// Calls launch(slots) with `slots` cast to uint16 if slot_u16, else int32;
// `launch` is a generic lambda that launches the kernel instantiation its
// argument's type selects.
template <typename Launch>
static inline void with_slot_type(const void* slots, int slot_u16,
                                  Launch launch) {
  if (slot_u16)
    launch(static_cast<const uint16_t*>(slots));
  else
    launch(static_cast<const int32_t*>(slots));
}
