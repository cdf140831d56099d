// pluginlib export macro placeholder: in the harness the class is linked
// directly; the macro only has to compile away cleanly.
#ifndef ROSSTUB_PLUGINLIB_CLASS_LIST_MACROS_HPP_
#define ROSSTUB_PLUGINLIB_CLASS_LIST_MACROS_HPP_

#define PLUGINLIB_EXPORT_CLASS(klass, base) \
  static_assert(true, "pluginlib export stub");

#endif // ROSSTUB_PLUGINLIB_CLASS_LIST_MACROS_HPP_
